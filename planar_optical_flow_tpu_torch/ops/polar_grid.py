"""TSDF-style polar occupancy grid encoding (the ``fc2d`` network input).

Counterpart of ``planar_optical_flow_tpu/ops/polar_grid.py``: every beam's
range becomes a column of ``R`` range bins holding the truncated signed
distance of each bin to the hit bin, and the hit bin the (optionally
normalized) measured range.

Arithmetic: the f32 steps are those XLA's compiled program takes, which is
what the JAX train step computes: each division by a configuration constant
(``range_bin_size``, the range span) is a multiply by the constant's f32
reciprocal. The hit bin is the ``int32`` truncation of that product, so a
range on a bin edge falls in the bin JAX's step puts it in (an eager,
uncompiled JAX call divides, and puts some edge ranges one bin lower).
"""

from __future__ import annotations

import torch

from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import recip


def num_range_bins(min_range: float = 0.0, max_range: float = 30.0,
                   range_bin_size: float = 1.0) -> int:
    """Range bins of the grid, counted in Python floats as JAX counts them
    (301 from 0 to 30 m at 0.1 m)."""
    return int((max_range - min_range) / range_bin_size) + 1


def scans_to_polar_grid(
    scans,
    min_range: float = 0.0,
    max_range: float = 30.0,
    range_bin_size: float = 1.0,
    tsdf_clip: float = 1.0,
    normalize: bool = True,
):
    """``(..., S, P)`` scans -> ``(..., S, R, P)`` f32 grids on the scans'
    device."""
    scans = torch.as_tensor(scans).float()
    num_range = num_range_bins(min_range, max_range, range_bin_size)
    mag = max_range - min_range
    mid = 0.5 * (max_range - min_range)

    scans = torch.clamp(scans, min_range, max_range)
    hit_bin = ((scans - min_range) * recip(range_bin_size)).to(torch.int32)
    hit = hit_bin[..., None, :].float()  # (..., S, 1, P)

    bins = torch.arange(num_range, dtype=torch.float32,
                        device=scans.device)[:, None]  # (R, 1)
    if tsdf_clip > 0.0:
        # signed distance of every bin to the hit bin, in meters, truncated
        tsdf = torch.clamp((bins - hit) * range_bin_size, -tsdf_clip,
                           tsdf_clip)
    else:
        tsdf = torch.zeros(scans.shape[:-1] + (num_range, scans.shape[-1]),
                           device=scans.device)

    val = scans
    if normalize:
        val = (val - mid) * recip(mag) * 2.0
        tsdf = tsdf * recip(mag) * 2.0

    return torch.where(bins == hit, val[..., None, :], tsdf)
