"""int8 DROW conv stacks: host-side calibration and the quantized
evaluator of ``make_quantized_stream_step``.

Counterpart of ``planar_optical_flow_tpu/ops/quantized_drow.py``:

* calibration: symmetric per-channel int8 weights and per-layer activation
  scales from a representative f32 sample, in plain numpy f32 on the host,
  the same operations in the same order as the JAX package, so that both
  packages compute the same scales from the same sample;
* :class:`QuantizedConvStack`, :func:`build_quantized_backbone`,
  :func:`build_quantized_head_convs` and :func:`quantized_head_apply`:
  int8 x int8 -> int32 conv products, the f32 dequant + bias + leaky, max
  pools and requant to the next layer's scale, in plain torch (the JAX
  package leaves them to XLA: no kernel of its own). The int32 sums are
  exact: ``torch._int_mm`` on the card (K padded to a multiple of 8), a
  float64 product on the CPU (a head layer reaches 1536 * 127^2 > 2^24,
  beyond f32's exact integers), both over chunks of rows.
"""

from __future__ import annotations

import numpy as np
import torch

from planar_optical_flow_tpu_torch import resolve_device

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


_ROWS = 8192  # cutouts per pass of the quantized stacks (bounds memory)


def _int8_matmul(a, b):
    """Exact int32 sums of ``a (M, K) int8 @ b (K, N) int8``, as f32 (the
    JAX ``astype(f32)`` of its int32 product)."""
    if a.device.type == "cuda":
        k = a.shape[1]
        pad = -k % 8
        if pad:
            a = torch.nn.functional.pad(a, (0, pad))
            b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        m = a.shape[0]
        if m <= 16:  # torch._int_mm takes more than 16 rows
            a = torch.nn.functional.pad(a, (0, 0, 0, 17 - m))
        return torch._int_mm(a.contiguous(), b.contiguous())[:m].float()
    return (a.double() @ b.double()).float()


def _requant(y, scale):
    """``clip(rint(y / scale), -127, 127)`` as int8, one f32 division by
    the 0-dim f32 tensor ``scale`` (on ``y``'s device: PyTorch on CUDA
    multiplies by the reciprocal of a Python scalar instead)."""
    return torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)


class QuantizedConvStack:
    """Baked int8 evaluator for a pooled k=3 SAME conv stack.

    ``layers``: folded ``(w (3, Cin, Cout), b (Cout,))`` f32 pairs (torch or
    numpy); ``pools``: the indices of layers followed by a 2x max pool;
    ``in_scale``/``act_scales`` from :func:`calibrate`; ``dequant_last``:
    return the last activation in f32 (else int8 at ``out_scale``).
    ``device``: where the weights live (the inputs' device); the card by
    default, which raises without one (pass ``device="cpu"``).
    """

    def __init__(self, layers, pools, in_scale, act_scales,
                 dequant_last=True, device="cuda"):
        device = resolve_device(device)
        self.pools = tuple(pools)
        self.in_scale = float(in_scale)
        self.act_scales = [float(v) for v in act_scales]
        self.dequant_last = dequant_last
        self.out_scale = self.act_scales[-1]
        # the int8 weights, biases, the dequant scales f32(s_in * w_scale)
        # and the requant divisors, made once on the device
        self.wq, self.bias, self._deq = [], [], []
        self._in_t = torch.tensor(self.in_scale, device=device)
        self._act_t = [torch.tensor(v, device=device)
                       for v in self.act_scales]
        s_in = self.in_scale
        for i, (w, b) in enumerate(layers):
            q, ws = quantize_weight(_numpy(w))
            self.wq.append(torch.from_numpy(q).to(device))
            self.bias.append(torch.from_numpy(_numpy(b)).to(device))
            self._deq.append(torch.from_numpy(
                np.float32(s_in) * ws).double().to(device))
            s_in = self.act_scales[i]

    def quantize_input(self, x):
        """f32 ``(T, L, Cin)`` -> int8 at the calibrated input scale."""
        return _requant(x.float(), self._in_t)

    def _run(self, x_q):
        last = len(self.wq) - 1
        for i, (wq, deq, b) in enumerate(zip(self.wq, self._deq, self.bias)):
            t, length, cin = x_q.shape
            z = torch.zeros_like(x_q[:, :1])
            xc = torch.cat([torch.cat([z, x_q[:, :-1]], 1), x_q,
                            torch.cat([x_q[:, 1:], z], 1)], dim=-1)
            y32 = _int8_matmul(xc.reshape(t * length, 3 * cin), wq)
            # f32(acc) * f32(s_in * ws) + b, rounded once (XLA fuses the
            # multiply-add)
            y = (y32.double() * deq + b.double()).float()
            y = torch.where(y > 0, y, _LEAKY * y).reshape(t, length, -1)
            if i in self.pools:
                y = y.reshape(t, length // 2, 2, -1).amax(2)
            if i == last and self.dequant_last:
                return y
            x_q = _requant(y, self._act_t[i])
        return x_q

    def __call__(self, x_q):
        """int8 ``(T, L, Cin)`` -> f32 (or int8) ``(T, L', Cout)``."""
        return torch.cat([self._run(x_q[i:i + _ROWS])
                          for i in range(0, x_q.shape[0], _ROWS)])


def build_quantized_backbone(folded_weights, calib_cutouts, device="cuda"):
    """``folded_weights``: the six backbone convs ``[(w, b), ...]``
    (``ops/kernels/fused_drow.backbone_weights``); ``calib_cutouts``: f32
    ``(N, L)`` representative cutouts; ``device`` as for
    :class:`QuantizedConvStack`."""
    layers = [(_numpy(w), _numpy(b)) for w, b in folded_weights]
    pools = (2, 5)
    sample = _numpy(calib_cutouts)[..., None]
    in_scale, act_scales = calibrate(layers, pools, sample)
    return QuantizedConvStack(layers, pools, in_scale, act_scales,
                              device=device)


def build_quantized_head_convs(folded_weights, calib_feats, device="cuda"):
    """Quantized head convs (block3 + block4; the mean and the cls/reg
    linears stay f32). ``folded_weights``: the head's five convs, then cls
    and reg (``ops/kernels/fused_drow.head_weights``); ``calib_feats``: f32
    ``(N, L4, 256)``; ``device`` as for :class:`QuantizedConvStack`.
    Returns (stack, (wc, bc, wr, br))."""
    device = resolve_device(device)
    layers = [(_numpy(w), _numpy(b)) for w, b in folded_weights[:5]]
    pools = (2,)
    in_scale, act_scales = calibrate(layers, pools, _numpy(calib_feats))
    stack = QuantizedConvStack(layers, pools, in_scale, act_scales,
                               device=device)
    (wc, bc), (wr, br) = folded_weights[5:7]
    heads = tuple(torch.from_numpy(_numpy(t)).to(device)
                  for t in (wc, bc, wr, br))
    return stack, heads


def quantized_head_apply(stack, heads, feats_q):
    """int8 head: the conv stack (f32 out), the mean over positions (f32:
    the sum times the f32 reciprocal of the count, XLA's form of the
    division), then the f32 cls/reg linears."""
    wc, bc, wr, br = heads
    y = stack(feats_q)
    y = y.sum(dim=1) * float(np.float32(1.0) / np.float32(y.shape[1]))
    return y @ wc + bc, y @ wr + br


def _numpy(t):
    """f32 numpy copy of a tensor or array."""
    if torch.is_tensor(t):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)
