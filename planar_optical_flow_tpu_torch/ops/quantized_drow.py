"""Host-side int8 calibration of the DROW conv stacks.

The port's own copy of what calibration needs from
``planar_optical_flow_tpu/ops/quantized_drow.py``: symmetric per-channel
int8 weights and per-layer activation scales from a representative f32
sample. Plain numpy f32 on the host, the same operations in the same order
as the JAX package, so that both packages compute the same scales from the
same sample.
"""

from __future__ import annotations

import numpy as np

_LEAKY = 0.1
_QMAX = 127.0


def quantize_weight(w: np.ndarray):
    """(3, Cin, Cout) f32 -> (w_int8 (3Cin, Cout), scale (Cout,))."""
    w = np.asarray(w, np.float32).reshape(-1, w.shape[-1])
    scale = np.abs(w).max(axis=0) / _QMAX
    scale = np.maximum(scale, 1e-12)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _f32_reference_chain(x, layers, pools):
    """Folded-f32 evaluation of a k=3 SAME conv stack on ``x (T, L, Cin)``,
    returning every layer's activation (after its pool, if any)."""
    acts = []
    for i, (w, b) in enumerate(layers):
        t, l, cin = x.shape
        left = np.concatenate([np.zeros_like(x[:, :1]), x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], np.zeros_like(x[:, :1])], axis=1)
        xc = np.concatenate([left, x, right], axis=-1)
        y = xc.reshape(t * l, -1) @ np.asarray(w, np.float32).reshape(
            -1, w.shape[-1]
        ) + np.asarray(b, np.float32)
        y = np.where(y > 0, y, _LEAKY * y).reshape(t, l, -1)
        if i in pools:
            tt, ll, cc = y.shape
            y = y.reshape(tt, ll // 2, 2, cc).max(axis=2)
        acts.append(y)
        x = y
    return acts


def _amax_scale(a, percentile=None):
    """abs-max (or abs-percentile, for outlier-robust clipping) -> int8
    scale. ``percentile`` in (0, 100]; None means the exact abs-max."""
    if percentile is not None and not 0.0 < percentile <= 100.0:
        raise ValueError(
            f"calib percentile must be in (0, 100], got {percentile}")
    a = np.abs(np.asarray(a, np.float32))
    if percentile is None or percentile >= 100.0:
        m = float(a.max())
    else:
        m = float(np.percentile(a, percentile))
    return max(m, 1e-6) / _QMAX


def calibrate(layers, pools, sample, in_scale=None, percentile=None):
    """Per-layer activation scales from a representative f32 sample
    ``(T, L, Cin)``. Returns (in_scale, act_scales list). ``percentile``
    clips at that abs-percentile instead of the exact abs-max; values above
    the clip saturate at +-127, as the int8 kernels do."""
    sample = np.asarray(sample, np.float32)
    if in_scale is None:
        in_scale = _amax_scale(sample, percentile)
    acts = _f32_reference_chain(sample, layers, pools)
    scales = [_amax_scale(a, percentile) for a in acts]
    return float(in_scale), scales
