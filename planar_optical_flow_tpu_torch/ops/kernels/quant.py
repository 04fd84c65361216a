"""int8 quantization of the folded DROW conv stacks for K5 and K7.

Counterparts in ``planar_optical_flow_tpu/ops/pallas/conv_stack.py``:
``stack_act_scales``, ``quantize_stack_int8`` (``concat_taps=True``),
``quantize_int8`` and the layer-1 fold of ``l1_mm_weights``. Quantization
reads the f32 folded weights (``fold.block_params``), never the bf16
weights K2/K4 take, and runs in numpy f32 on the host in the JAX package's
order, so both packages derive the same int8 weights and epilogue constants
from the same scales.

Per conv layer i: ``q_{i+1} = clip(rint(leaky(f32(acc_i32) * s_eff +
b_eff)), -127, 127)`` with ``s_eff = s_in * w_scale / s_out`` and ``b_eff =
b / s_out``; with ``dequant_last`` the last layer stays f32 (``s_eff = s_in
* w_scale``, ``b_eff = b``).
"""

from __future__ import annotations

import numpy as np
import torch

from planar_optical_flow_tpu_torch.ops import quantized_drow as qd
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import div_f32


def _np(t):
    return (t.detach().float().cpu().numpy() if torch.is_tensor(t)
            else np.asarray(t, np.float32))


def _np_blocks(block_param_list):
    return [(_np(w), _np(b)) for w, b in block_param_list]


def stack_act_scales(block_param_list, sample, pool_after, in_scale=None,
                     percentile=None):
    """Calibrate a conv stack: f32 ``sample (N, L, Cin)`` -> (in_scale,
    per-layer activation scales). ``block_param_list``: folded ``(w (3,
    Cin, Cout), b)`` pairs, torch or numpy."""
    sample = np.asarray(_np(sample), np.float32)
    if in_scale is None:
        in_scale = qd._amax_scale(sample, percentile)
    return qd.calibrate(_np_blocks(block_param_list), set(pool_after), sample,
                        in_scale=in_scale, percentile=percentile)


def quantize_stack_int8(block_param_list, sample, pool_after,
                        in_scale=None, dequant_last=True, act_scales=None):
    """Folded f32 ``(w (3, Cin, Cout), b)`` list -> ``([(wcat (3*Cin, Cout)
    int8, s_eff (Cout,) f32, b_eff (Cout,) f32), ...], in_scale,
    out_scale or None)``, numpy.

    ``wcat`` is tap-major (rows ``[0:Cin]`` = left tap), the JAX
    ``concat_taps=True`` layout. With ``in_scale`` and ``act_scales`` (a
    restored ``ServeCalibration``) no ``sample`` is needed. (The JAX
    function's ``l0`` argument does not enter the result and is dropped.)
    """
    blocks = _np_blocks(block_param_list)
    if act_scales is None:
        in_scale, act_scales = stack_act_scales(blocks, sample, pool_after,
                                                in_scale=in_scale)
    elif in_scale is None:
        raise ValueError("act_scales requires an explicit in_scale")
    out = []
    s_in = in_scale
    for i, (w, b) in enumerate(blocks):
        wq, ws = qd.quantize_weight(w)
        s_out = act_scales[i]
        if i == len(blocks) - 1 and dequant_last:
            s_eff, b_eff = s_in * ws, b
        else:
            s_eff, b_eff = s_in * ws / s_out, b / s_out
        out.append((wq, s_eff.astype(np.float32), b_eff.astype(np.float32)))
        s_in = s_out
    return out, float(in_scale), (None if dequant_last else act_scales[-1])


def kernel_stack_weights(stack, device):
    """:func:`quantize_stack_int8` layers -> the layout K5/K7 read, on
    ``device``: ``[(w (Cout, 3*Cin) int8, s_eff, b_eff), ...]``; each output
    channel's 3*Cin taps are contiguous (the column operand of the int8
    MMA)."""
    return [(torch.from_numpy(np.ascontiguousarray(wq.T)).to(device),
             torch.from_numpy(s).to(device), torch.from_numpy(b).to(device))
            for wq, s, b in stack]


def layer1_int8_weights(layer1, in_scale: float, device=None):
    """Backbone layer 1 with the int8 input scale folded in (the layer-1
    fold of the JAX ``l1_mm_weights``): ``(w (3, 64) / in_scale, b (64,) /
    in_scale)`` f32, one f32 division each. Leaky is positively
    homogeneous, so ``leaky(y) / s == leaky(y / s)`` for ``s > 0``."""
    w, b = layer1  # (3, 1, 64), (64,)
    s = np.float32(in_scale)
    ws = _np(w)[:, 0, :] / s
    bs = _np(b) / s
    dev = device if device is not None else (
        w.device if torch.is_tensor(w) else "cpu")
    return (torch.from_numpy(np.ascontiguousarray(ws)).to(dev),
            torch.from_numpy(np.ascontiguousarray(bs)).to(dev))


def quantize_int8(x, scale: float):
    """f32 -> int8 at ``scale`` (symmetric): ``clip(rint(x / scale))`` with
    one f32 division."""
    return torch.clamp(torch.round(div_f32(x.float(), scale)), -127,
                       127).to(torch.int8)
