"""Batched per-beam cutout extraction (the module engine's encoder).

Counterpart of ``planar_optical_flow_tpu/ops/cutout.py``, with every option
of the JAX function: ``fixed`` (each scan sets its own window geometry; with
``fixed=False`` every scan of the stack is windowed with the most recent
scan's ranges), ``stride`` (output beams ``phi[::stride]``), centered or
not, point or area sampling. The window geometry runs in float32 whatever
the input dtype.

Sampling uses ``torch.gather``. In area mode the JAX ``gather_mode`` picks
between different area estimates, and so does this port:

* ``"matmul"``: the band mean over beams ``rint(ind -+ tap_w/2)``, the
  estimate the fused cutout kernel also computes. JAX gathers here with a
  one-hot bf16 matmul on a hi/lo bf16 split of the ranges, so every sampled
  range carries 16 significant bits (``hi + lo``), and a band sum is the f32
  sum of the hi parts plus that of the lo parts. The port samples the same
  split values (each part's band sum is exact: from a float64 prefix sum).
  Exact ranges instead shift the f32 cutouts by up to ~2e-4, which moves the
  int8 head calibration taken from the module step by up to ~2e-5
  relative. ``area_fast`` has no effect in this mode, as in JAX;
* ``"gather"`` with ``area_fast``: the same band mean as a box filter over
  an f32 prefix sum of the exact ranges, taken in the order XLA's CPU
  backend computes ``jnp.cumsum`` (``ops/kernels/cutout_kernel.py
  prefix_sum``), so that a band sum is the same difference of two rounded
  running sums;
* ``"gather"``: the mean of ``area_s`` rint-rounded oversampled taps per
  output tap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
    div_f32,
    prefix_sum,
)


def area_s_for(window_width: float, num_cutout_pts: int,
               angle_inc: float = math.radians(0.5),
               min_range: float = 1e-2) -> int:
    """Worst-case area-sampling factor: the widest possible angular window
    (a point at ``min_range``) divided by the cutout resolution."""
    max_half_alpha = math.atan(0.5 * window_width / min_range)
    max_window_pts = 2.0 * max_half_alpha / angle_inc
    return max(1, int(math.ceil(max_window_pts / num_cutout_pts)))


def _gather_last(table, inds):
    """``table (..., P)`` gathered at ``inds (..., P', K)`` along the beams."""
    flat = inds.reshape(*inds.shape[:-2], -1)
    return torch.gather(table, -1, flat).reshape(inds.shape)


def split16(x):
    """The hi/lo bf16 split of f32 ``x`` the JAX matmul gather contracts
    with: ``(hi, lo)`` as f32, ``hi = bf16(x)``, ``lo = bf16(x - hi)``."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _band_sum(values, a_lo, a_hi):
    """f32 sum of ``values (..., P)`` over the beam bands ``[a_lo, a_hi]``
    (``(..., P', K)`` int64) from a float64 prefix sum with a leading zero
    (``csum[i]`` = sum of beams < i); exact for the split parts."""
    csum = torch.cumsum(values.double(), dim=-1)
    csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
    return (_gather_last(csum, a_hi + 1) - _gather_last(csum, a_lo)).float()


def band_mean(scans, a_lo, a_hi):
    """Mean of ``scans (..., P)`` over the beam bands ``[a_lo, a_hi]`` as the
    JAX matmul gather computes it: (sum of the hi parts + sum of the lo
    parts) / count, in f32."""
    hi, lo = split16(scans)
    sums = _band_sum(hi, a_lo, a_hi) + _band_sum(lo, a_lo, a_hi)
    return sums / (a_hi - a_lo + 1).float()


def _area_band(inds, c: int, num_pts: int):
    """The beam band ``[rint(ind - tap_w/2), rint(ind + tap_w/2)]`` of each
    tap (``(..., P', C)`` int64 each; ``tap_w`` the window's span over ``c -
    1``), clamped to the scan and to ``lo <= hi``."""
    tap_w = div_f32(inds[..., -1:] - inds[..., 0:1], c - 1)
    a_lo = torch.round(torch.clamp(inds - 0.5 * tap_w, 0, num_pts - 1)).long()
    a_hi = torch.round(torch.clamp(inds + 0.5 * tap_w, 0, num_pts - 1)).long()
    return a_lo, torch.maximum(a_hi, a_lo)


def scans_to_cutout(
    scans,
    scan_phi,
    stride: int = 1,
    centered: bool = True,
    fixed: bool = False,
    window_width: float = 1.66,
    window_depth: float = 1.0,
    num_cutout_pts: int = 48,
    padding_val: float = 29.99,
    area_mode: bool = False,
    area_s: int | None = None,
    area_fast: bool = False,
    gather_mode: str = "gather",
):
    """``(..., S, P)`` range scans -> ``(..., P', S, C)`` cutouts, ``P' =
    ceil(P / stride)``.

    Same contract as the JAX function; see the module docstring for the
    area estimates. Geometry runs in float32 whatever the input dtype;
    each division is one IEEE f32 division on either device (``div_f32``:
    CUDA would multiply by a rounded reciprocal), so that the card's taps
    and band edges are the CPU's, up to the ulps of ``atan``.
    """
    if gather_mode not in ("gather", "matmul"):
        raise ValueError(f"unknown gather_mode {gather_mode!r}")
    scans = torch.as_tensor(scans)
    out_dtype = scans.dtype
    x = scans.float()
    num_pts = x.shape[-1]
    phi = np.asarray(scan_phi)
    angle_inc = float(phi[1] - phi[0])
    phi0 = float(phi[0])
    phi_s = torch.as_tensor(phi[::stride].copy(), dtype=torch.float32,
                            device=x.device)
    c = num_cutout_pts

    dists = x[..., ::stride]  # (..., S, P')
    if not fixed:
        # every scan windowed with the most recent scan's ranges
        dists = dists[..., -1:, :].expand(dists.shape)
    half_alpha = torch.atan(div_f32(0.5 * window_width,
                                    torch.clamp(dists, min=1e-2)))

    def window_indices(n_samples):
        # angles of the window taps -> fractional beam indices
        delta = div_f32(2.0 * half_alpha, n_samples - 1)
        taps = torch.arange(n_samples, dtype=torch.float32, device=x.device)
        ang = (phi_s - half_alpha)[..., None] + taps * delta[..., None]
        return div_f32(ang - phi0, angle_inc)  # (..., S, P', n_samples)

    inds = window_indices(c)
    outbound = (inds < 0) | (inds > num_pts - 1)
    low = torch.clamp(torch.floor(inds), 0, num_pts - 1).long()
    high = torch.clamp(low + 1, 0, num_pts - 1)
    frac = torch.clamp(inds - low.float(), 0.0, 1.0)
    if gather_mode == "matmul":
        hi, lo = split16(x)
        sampled = hi + lo
    else:
        sampled = x
    ct_low = _gather_last(sampled, low)
    ct_high = _gather_last(sampled, high)
    ct = ct_low + frac * (ct_high - ct_low)

    if area_mode:
        window_span = inds[..., -1:] - inds[..., 0:1]
        use_area = window_span > c
        if gather_mode == "matmul":
            a_lo, a_hi = _area_band(inds, c, num_pts)
            ct = torch.where(use_area, band_mean(x, a_lo, a_hi), ct)
        elif area_fast:
            # the box filter: differences of the f32 prefix sum with a
            # leading zero (csum[i] = sum of beams < i)
            csum = prefix_sum(x)
            csum = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=-1)
            a_lo, a_hi = _area_band(inds, c, num_pts)
            sums = _gather_last(csum, a_hi + 1) - _gather_last(csum, a_lo)
            ct = torch.where(use_area, sums / (a_hi - a_lo + 1).float(), ct)
        else:
            s = (area_s_for(window_width, c, angle_inc) if area_s is None
                 else int(area_s))
            if s > 1:
                inds_area = torch.round(torch.clamp(
                    window_indices(s * c), 0, num_pts - 1)).long()
                ct_area = _gather_last(x, inds_area)
                # tap k of the oversampled window maps to k // s
                ct_area = ct_area.reshape(*ct_area.shape[:-1], c, s).mean(-1)
                ct = torch.where(use_area, ct_area, ct)

    ct = torch.where(outbound, torch.full_like(ct, padding_val), ct)
    ct = torch.minimum(torch.maximum(ct, (dists - window_depth)[..., None]),
                       (dists + window_depth)[..., None])
    if centered:
        ct = div_f32(ct - dists[..., None], window_depth)
    return ct.transpose(-3, -2).to(out_dtype)
