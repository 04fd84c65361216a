"""K2, K4 (bf16) and K5, K7, K9, K10 (int8): the fused DROW conv stacks
(``csrc/backbone_bf16.cu``, ``csrc/head_bf16.cu``,
``csrc/conv_stack_int8.cu``), and K16, the check of the int8 kernels' tap
rows.

* K2 :func:`backbone_bf16` replaces ``planar_optical_flow_tpu/ops/pallas/
  conv_stack.py`` ``fused_backbone_v2`` with ``embed_weights`` (body
  ``_backbone_kernel``/``_run_plan``/``_conv_rolled``, epilogue
  ``_embed_epilogue``) together with the XLA layer 1 the v3 step runs in
  front of it (``backbone_layer1``): ``(N, L)`` f32 cutouts -> layer 1
  (1 -> 64, rounded as :func:`backbone_layer1` rounds it) -> backbone
  layers 2-6 (conv, conv, pool/2, conv, conv, conv, pool/2) -> feats
  ``(N*L/4, 256)`` bf16 and the gate embedding ``zx = feats @ W + b``
  ``(N, 128)`` bf16. :func:`backbone_tail` is the JAX function's own
  interface, the layer-1 activation ``(N*L, 64)`` bf16 in, on the same
  kernel: :func:`backbone_layer1` then :func:`backbone_tail` equals
  :func:`backbone_bf16` to the bit.
* K4 :func:`head` replaces ``fused_head_v2`` (``_head_kernel``,
  ``_head_cls_reg``): head convs (conv, conv, conv, pool/2, conv, conv), the
  mean over positions and the cls/reg linears. ``(N*L4, 256)`` bf16 ->
  cls ``(N, classes)`` f32, reg ``(N, 2)`` f32.

Every conv is k=3 SAME with BatchNorm folded in and LeakyReLU 0.1; rounding
follows the JAX kernels: bf16 MMA operands, f32 accumulation, f32
activations between layers (stored as their bf16 MMA operand, which is the
same value since bf16 rounding is monotonic), feats stored bf16, zx cast to
bf16 from the f32 product, the position mean taken in f32.

Bound on the H100: operations. K2 does ~16.1 MFLOP per cutout at L=56 (the
embed included) and K4 ~28.9 MFLOP at L4=14, against 7.4 KB and 7 KB of
HBM traffic per cutout. The kernels keep a tile of cutouts' activations in
shared memory across all layers (HBM sees only the input and the outputs,
which is what the TPU kernels bought), and both run on the wgmma conv of
K7 in bf16 (``csrc/wgmma_conv.cuh``: 8 cutouts a block in a packed tile,
the conv weights laid out once by :func:`backbone_weights_bf16` /
:func:`head_weights_bf16` and staged through a ring in shared memory).
K2's gate embed is K5's embed kernel (``csrc/embed.cuh``) on its bf16
feats, launched by the same entry.

The int8 stacks, weights from ``quant.kernel_stack_weights``:

* K5 :func:`backbone_int8` replaces ``fused_backbone_int8_p2``
  (``l1_mode="mm"``, int8 output, with ``embed_weights``): layer 1 from the
  f32 cutouts (``1/in_scale`` folded into its weights), the five tail convs
  as s8 x s8 -> s32 products with the f32 epilogue ``clip(rint(leaky(
  f32(acc) * s_eff + b_eff)))``, int8 feats ``(N*L/4, 256)`` and zx ``(N,
  128)`` bf16 through ``W * feat_scale``.
* K9 :func:`backbone_int8_pm` replaces ``fused_backbone_int8_pm`` with
  ``layer1_weights`` (and ``fused_backbone_int8_p2`` with ``l1_mode=
  "repack"``/``"blend"``, bit-identical to it in JAX): K5 with layer 1
  rounded as ``clip(rint(leaky(acc) / in_scale))``, one true division, on
  the unscaled weights.
* K8 :func:`backbone_int8_cut` replaces ``fused_backbone_int8_p2cut``: K1's
  cutouts of the padded scans (``cutout_kernel.cutout``) in front of K5's
  block, bit-identical to the two; the ``(N, L)`` cutouts never reach
  device memory.
* K10 :func:`backbone_int8_tail` replaces ``fused_backbone_int8`` (both
  ``conv_mode``s, which JAX makes bit-identical): K5's tail convs and embed
  on the int8 layer-1 activation ``(N*L, 64)`` from
  :func:`backbone_layer1` with ``out_scale``; int8 feats, or bf16 feats
  (the last layer dequantized) with the unscaled embed weight.
* K7 :func:`head_int8` replaces ``fused_head_int8_pm``: the head convs on
  the int8 template (the last one dequantized), the f32 position mean (a
  sequential sum, then one division) and the bf16 cls/reg products. K10's
  head, ``fused_head_int8``, computes the same function on the same
  cutout-major rows, and runs on K7.
* K16 :func:`row_shift` / :func:`check_row_shift` replace
  ``check_byte_shift``: the known-answer check of the k=3 tap rows.

Every int8 conv stack (K5, K7-K10, and K12 and K13, ``fast_gate.
gate_head_int8`` and ``serve_cell``) runs on ``wgmma`` s8 products over a
packed tile of 16 cutouts, with the conv weights staged in shared memory by
cp.async (``csrc/wgmma_conv.cuh``, ``csrc/int8_wg.cuh``); the host lays the
weights out once per set of weights (:func:`backbone_weights_int8`,
:func:`head_weights_int8`, held by the step builder; a caller passing the
triples has them laid out on every call). The gate embed of K5/K8/K9/K10
is a second kernel over all cutouts. ~15.1 M and 28.9 M int8 operations
per cutout. The plain versions sum the int8 products in float64, which is
exact (the 512-channel conv reaches 1536 * 127^2 > 2^24, beyond f32's
exact integers).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from planar_optical_flow_tpu_torch.ops.kernels import _build, int8_tiles
from planar_optical_flow_tpu_torch.ops.kernels import library
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import (
    cutout_plain,
    div_f32,
    recip,
)

_LEAKY_SLOPE = 0.1
BACKBONE_CHANNELS = (64, 64, 128, 128, 128, 256)  # layer-1 out, then 2..6
HEAD_CHANNELS = (256, 256, 256, 512, 256, 128)
_BACKBONE_POOL_AFTER = (1, 4)  # pool after tail layers 3 and 6
_HEAD_POOL_AFTER = (2,)


def backbone_layer1(cutouts, layer1, compute_dtype=torch.bfloat16,
                    out_scale=None):
    """Backbone layer 1 (Cin=1), plain PyTorch as XLA ran it in JAX:
    ``(N, L)`` cutouts -> ``(N*L, 64)`` activation in ``compute_dtype``.

    ``layer1``: ``(w (3, 1, 64) or (3, 64), b (64,))`` f32. With
    ``out_scale`` the activation is requantized for the int8 stacks:
    ``clip(rint(leaky(acc) / out_scale))`` int8, one f32 division."""
    w, b = layer1
    x = cutouts.float()
    z = torch.zeros_like(x[:, :1])
    left = torch.cat([z, x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], z], dim=1)
    wc = w.reshape(3, -1)
    acc = (left[..., None] * wc[0] + x[..., None] * wc[1]
           + right[..., None] * wc[2]) + b
    act = torch.where(acc > 0, acc, _LEAKY_SLOPE * acc).reshape(-1, 64)
    if out_scale is not None:
        return _requant(div_f32(act, out_scale))
    return act.to(compute_dtype)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _conv_plain(x, wcat, b):
    """k=3 SAME conv of ``(N, Cin, L)`` f32 on bf16-rounded operands."""
    cin = x.shape[1]
    w = wcat.float().reshape(3, cin, -1).permute(2, 1, 0)  # (Cout, Cin, 3)
    acc = F.conv1d(_bf16(x), w, padding=1) + b.float()[:, None]
    return torch.where(acc > 0, acc, _LEAKY_SLOPE * acc)


def _run_plain(x, weights, pool_after):
    for i, (w, b) in enumerate(weights):
        x = _conv_plain(x, w, b)
        if i in pool_after:
            x = F.max_pool1d(x, 2)
    return x


def backbone_tail_plain(act1, weights, embed_weights, *, l: int):
    """Plain PyTorch version of :func:`backbone_tail`."""
    n = act1.shape[0] // l
    x = act1.float().reshape(n, l, -1).transpose(1, 2)
    y = _run_plain(x, weights, _BACKBONE_POOL_AFTER)  # (N, 256, L/4)
    feats = y.transpose(1, 2).to(torch.bfloat16)  # (N, L/4, 256)
    we, be = embed_weights
    zx = feats.float().reshape(n, -1) @ we.float() + be.float()
    return feats.reshape(-1, 256), zx.to(torch.bfloat16)


def head_plain(feats, conv_weights, head_weights, *, l4: int):
    """Plain PyTorch version of :func:`head`."""
    n = feats.shape[0] // l4
    x = feats.float().reshape(n, l4, -1).transpose(1, 2)
    y = _run_plain(x, conv_weights, _HEAD_POOL_AFTER)
    # mean over positions in the JAX kernel's order: running sum, then / k
    acc = y[..., 0]
    for i in range(1, y.shape[-1]):
        acc = acc + y[..., i]
    pooled = _bf16(acc / y.shape[-1])
    wc, bc, wr, br = head_weights
    return pooled @ wc.float() + bc.float(), pooled @ wr.float() + br.float()


def _check_weights(weights, chans, what):
    if len(weights) != len(chans) - 1:
        raise ValueError(f"{what}: need {len(chans) - 1} layers")
    for (w, b), cin, cout in zip(weights, chans[:-1], chans[1:]):
        if (w.dtype != torch.bfloat16 or tuple(w.shape) != (3 * cin, cout)
                or b.dtype != torch.float32 or tuple(b.shape) != (cout,)
                or not (w.is_contiguous() and b.is_contiguous())):
            raise ValueError(f"{what}: layer ({cin}->{cout}) weights must be "
                             "contiguous bf16 (3*Cin, Cout) and f32 (Cout,)")


def _check_cuda(t, dtype, shape, what):
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{what}: need {dtype} {shape} on cuda, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _ptrs(weights):
    return [p for w, b in weights for p in (w.data_ptr(), b.data_ptr())]


class Bf16Laid(NamedTuple):
    """A bf16 conv stack's weights laid out once for its wgmma kernel
    (:func:`head_weights_bf16`, K4; :func:`backbone_weights_bf16`, K2): the
    ``(w (3*Cin, Cout) bf16, b (Cout,) f32)`` pairs of ``fold`` and each
    ``w`` in the chunk order of its conv's plan
    (``int8_tiles.plan_weights_bf16``)."""
    convs: tuple
    laid: tuple


def head_weights_bf16(conv_weights) -> Bf16Laid:
    """Lay K4's conv weights out for its weight ring, once per set of
    weights: the step builders hold the result and pass it to :func:`head`
    on every call."""
    _check_weights(conv_weights, HEAD_CHANNELS, "head")
    return Bf16Laid(
        tuple(conv_weights),
        tuple(int8_tiles.plan_weights_bf16(conv_weights)))


def backbone_weights_bf16(weights) -> Bf16Laid:
    """Lay K2's backbone tail (layers 2-6, ``fold.backbone_stack_weights``)
    out for its weight ring, once per set of weights: the step builder
    holds the result and passes it to :func:`backbone_bf16` on every
    call."""
    _check_weights(weights, BACKBONE_CHANNELS, "backbone")
    return Bf16Laid(tuple(weights), tuple(int8_tiles.plan_weights_bf16(
        weights, int8_tiles.BACKBONE_BF16_PLAN)))


def _bf16_convs(weights):
    """The ``(w, b)`` pairs of ``weights``: a :class:`Bf16Laid` or the pairs
    themselves."""
    return weights.convs if isinstance(weights, Bf16Laid) else weights


def check_head_bf16_plan(lib):
    """Raise unless the library's K4 plan chunks the weights as
    ``int8_tiles.HEAD_BF16_PLAN`` lays them out (once per process)."""
    if check_head_bf16_plan.checked:
        return
    fn = lib.head_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
    _check_plan("head", fn, int8_tiles.HEAD_BF16_PLAN, 2)
    check_head_bf16_plan.checked = True


check_head_bf16_plan.checked = False


def head(feats, conv_weights, head_weights, *, num_classes: int, l4: int):
    """Head convs + position mean + cls/reg: ``(N*l4, 256)`` bf16 -> (cls
    ``(N, num_classes)`` f32, reg ``(N, 2)`` f32).

    ``conv_weights``: :func:`head_weights_bf16` of ``fold.
    head_stack_weights``' conv weights (a caller that passes the pairs
    themselves has them laid out on every call); ``head_weights`` the
    cls/reg weights. Runs ``pof_torch::head``: K4 on a CUDA tensor,
    :func:`head_plain` on a CPU tensor.
    """
    convs, laid = library.bf16_stack(conv_weights)
    return torch.ops.pof_torch.head(feats, convs, laid, list(head_weights),
                                    num_classes, l4)


def _cuda_head(feats, conv_weights, head_weights, *, num_classes, l4):
    """K4's launch: the CUDA kernel of ``pof_torch::head``."""
    if l4 % 2 or not 2 <= l4 <= 32:
        raise ValueError(f"head: l4={l4} must be even and in [2, 32]")
    if not 1 <= num_classes <= 8:
        raise ValueError(f"head: num_classes={num_classes} not in [1, 8]")
    if not isinstance(conv_weights, Bf16Laid):
        conv_weights = head_weights_bf16(conv_weights)
    n = feats.shape[0] // l4
    _check_cuda(feats, torch.bfloat16, (n * l4, 256), "head feats")
    for w, (_, b) in zip(conv_weights.laid, conv_weights.convs):
        _check_cuda(w, torch.bfloat16, (w.numel(),), "head laid-out w")
        _check_cuda(b, torch.float32, (b.numel(),), "head b")
    wc, bc, wr, br = head_weights
    _check_cuda(wc, torch.bfloat16, (128, num_classes), "head wc")
    _check_cuda(bc, torch.float32, (num_classes,), "head bc")
    _check_cuda(wr, torch.bfloat16, (128, 2), "head wr")
    _check_cuda(br, torch.float32, (2,), "head br")
    smem = int8_tiles.head_bf16_geometry(l4)[2]
    if smem > int8_tiles.SMEM_MAX:
        raise ValueError(f"head: {smem} bytes of shared memory at l4={l4}, "
                         f"over {int8_tiles.SMEM_MAX}")
    feats = feats.contiguous()
    wc, bc, wr, br = (t.contiguous() for t in head_weights)
    cls = torch.empty(n, num_classes, dtype=torch.float32, device=feats.device)
    reg = torch.empty(n, 2, dtype=torch.float32, device=feats.device)
    lib = _build.load("head_bf16")
    check_head_bf16_plan(lib)
    ptrs = [t.data_ptr() for w, (_, b) in zip(conv_weights.laid,
                                              conv_weights.convs)
            for t in (w, b)]
    convs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    fn = lib.head_bf16_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    _build.check(fn(feats.data_ptr(), convs, wc.data_ptr(), bc.data_ptr(),
                    wr.data_ptr(), br.data_ptr(), cls.data_ptr(),
                    reg.data_ptr(), n, l4, num_classes,
                    _build.stream_ptr(feats.device)), "head")
    head.launches += 1
    return cls, reg


# --------------------------------------------------------------------------
# K2 and K14's bf16 backbone: csrc/backbone_bf16.cu
# --------------------------------------------------------------------------

# layer-1 modes of the bf16 backbone kernel: K2 from the cutouts (torch's
# backbone_layer1 rounding), K14 (layer 1 on bf16-rounded cutouts), K2 from
# the bf16 act1 rows
L1_XLA, L1_CONV3, L1_READ = 0, 1, 2


def check_backbone_bf16_plan(lib):
    """Raise unless the library's bf16 backbone plan chunks the weights as
    ``int8_tiles.BACKBONE_BF16_PLAN`` lays them out (once per process)."""
    if check_backbone_bf16_plan.checked:
        return
    fn = lib.backbone_bf16_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 2
    _check_plan("backbone_bf16", fn, int8_tiles.BACKBONE_BF16_PLAN, 2)
    check_backbone_bf16_plan.checked = True


check_backbone_bf16_plan.checked = False


def launch_backbone_bf16(what, inp, ptrs, embed_weights, feats, zx, n, l,
                         l1_mode):
    """Launch ``csrc/backbone_bf16.cu`` in ``l1_mode`` on ``inp`` (the f32
    cutouts, or act1 in :data:`L1_READ`) into ``feats`` (and, but for
    :data:`L1_CONV3`, the gate embed into ``zx``). ``ptrs``: the 12
    pointers w1, b1 (None in :data:`L1_READ`) and (laid-out w, b) of convs
    2-6; ``embed_weights``: ``(W (l/4*256, 128) bf16, b (128,) bf16)`` or
    None."""
    smem = int8_tiles.backbone_bf16_geometry(l, l1_mode)[2]
    if smem > int8_tiles.SMEM_MAX:
        raise ValueError(f"{what}: {smem} bytes of shared memory at l={l}, "
                         f"over {int8_tiles.SMEM_MAX}")
    lib = _build.load("backbone_bf16")
    check_backbone_bf16_plan(lib)
    we_t = be = None
    if embed_weights is not None:
        we, be = embed_weights
        _check_cuda(we, torch.bfloat16, ((l // 4) * 256, 128), f"{what} W")
        _check_cuda(be, torch.bfloat16, (128,), f"{what} b")
        we_t, be = we.t().contiguous(), be.contiguous()
    fn = lib.backbone_bf16_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    _build.check(fn(inp.data_ptr(), (ctypes.c_void_p * 12)(*ptrs),
                    None if we_t is None else we_t.data_ptr(),
                    None if be is None else be.data_ptr(),
                    feats.data_ptr(), None if zx is None else zx.data_ptr(),
                    n, l, l1_mode, _build.stream_ptr(inp.device)), what)


def _launch_k2(what, inp, layer1, weights, embed_weights, l, l1_mode):
    """K2 on CUDA tensors: layer 1 from the cutouts (``layer1``) or the
    act1 rows (``layer1`` None), the tail convs (the pairs, laid out in
    this call, or a :class:`Bf16Laid`), the gate embed -> (feats, zx)."""
    if l % 4 or l < 4:
        raise ValueError(f"{what}: l={l} must be a positive multiple of 4")
    if not isinstance(weights, Bf16Laid):
        weights = backbone_weights_bf16(weights)
    if layer1 is None:
        n = inp.shape[0] // l
        _check_cuda(inp, torch.bfloat16, (n * l, 64), f"{what} act1")
        l1 = [None, None]
    else:
        n = inp.shape[0]
        _check_cuda(inp, torch.float32, (n, l), f"{what} cutouts")
        w1, b1 = layer1[0].reshape(3, 64), layer1[1]
        _check_cuda(w1, torch.float32, (3, 64), f"{what} layer-1 w")
        _check_cuda(b1, torch.float32, (64,), f"{what} layer-1 b")
        layer1 = (w1.contiguous(), b1.contiguous())
        l1 = [t.data_ptr() for t in layer1]
    for w, (_, b) in zip(weights.laid, weights.convs):
        _check_cuda(w, torch.bfloat16, (w.numel(),), f"{what} laid-out w")
        _check_cuda(b, torch.float32, (b.numel(),), f"{what} b")
    inp = inp.contiguous()
    feats = torch.empty(n * (l // 4), 256, dtype=torch.bfloat16,
                        device=inp.device)
    zx = torch.empty(n, 128, dtype=torch.bfloat16, device=inp.device)
    ptrs = l1 + [t.data_ptr() for w, (_, b) in zip(weights.laid,
                                                   weights.convs)
                 for t in (w, b)]
    launch_backbone_bf16(what, inp, ptrs, embed_weights, feats, zx, n, l,
                         l1_mode)
    return feats, zx


def backbone_bf16_plain(cutouts, layer1, weights, embed_weights, *, l: int):
    """Plain PyTorch version of :func:`backbone_bf16` (same arguments):
    :func:`backbone_layer1`, then :func:`backbone_tail_plain`."""
    return backbone_tail_plain(backbone_layer1(cutouts, layer1),
                               _bf16_convs(weights), embed_weights, l=l)


def backbone_bf16(cutouts, layer1, weights, embed_weights, *, l: int):
    """K2 with its layer 1: ``cutouts (N, l)`` f32 -> (feats ``(N*l/4,
    256)`` bf16, zx ``(N, 128)`` bf16).

    ``layer1``: ``(w (3, 1, 64) or (3, 64), b (64,))`` f32, the folded
    layer 1 of ``fold.backbone_stack_weights``, computed in the kernel as
    :func:`backbone_layer1` computes it (each f32 operation rounded once,
    leaky, bf16); ``weights``: :func:`backbone_weights_bf16` of the tail
    (a caller that passes the pairs has them laid out on every call);
    ``embed_weights``: ``(W (l/4*256, 128) bf16, b (128,) bf16)``. Runs
    ``pof_torch::backbone_bf16``: K2 on a CUDA tensor,
    :func:`backbone_bf16_plain` on a CPU tensor.
    """
    convs, laid = library.bf16_stack(weights)
    return torch.ops.pof_torch.backbone_bf16(
        cutouts, list(layer1), convs, laid, list(embed_weights), l)


def _cuda_backbone_bf16(cutouts, layer1, weights, embed_weights, *, l):
    """K2's launch: the CUDA kernel of ``pof_torch::backbone_bf16``."""
    out = _launch_k2("backbone_bf16", cutouts, layer1, weights,
                     embed_weights, l, L1_XLA)
    backbone_bf16.launches += 1
    return out


def backbone_tail(act1, weights, embed_weights, *, l: int):
    """K2 on its JAX interface, layers 2-6 + gate embed: ``act1 (N*l,
    64)`` bf16 (:func:`backbone_layer1`) -> (feats ``(N*l/4, 256)`` bf16,
    zx ``(N, 128)`` bf16).

    ``weights``: the tail from ``fold.backbone_stack_weights``, or its
    :func:`backbone_weights_bf16`; ``embed_weights`` as for
    :func:`backbone_bf16`. Runs ``pof_torch::backbone_tail``: on a CUDA
    tensor K2's kernel reading the act1 rows, on a CPU tensor
    :func:`backbone_tail_plain`.
    """
    convs, laid = library.bf16_stack(weights)
    return torch.ops.pof_torch.backbone_tail(act1, convs, laid,
                                             list(embed_weights), l)


def _cuda_backbone_tail(act1, weights, embed_weights, *, l):
    """K2's launch on act1: the CUDA kernel of ``pof_torch::backbone_tail``.
    """
    out = _launch_k2("backbone_tail", act1, None, weights, embed_weights, l,
                     L1_READ)
    backbone_tail.launches += 1
    return out


backbone_bf16.launches = 0
backbone_tail.launches = 0
head.launches = 0


# --------------------------------------------------------------------------
# K5, K7, K8, K9, K10 and K16: the int8 stacks (csrc/conv_stack_int8.cu).
# Weights from quant.kernel_stack_weights: per conv (w (Cout, 3*Cin) int8,
# s_eff (Cout,) f32, b_eff (Cout,) f32).
# --------------------------------------------------------------------------

_PLAIN_CHUNK = 8192  # cutouts per pass of the plain versions (bounds memory)


def _requant(y):
    """``clip(rint(y), -127, 127)`` as int8; ``torch.round`` rounds half to
    even, as ``jnp.rint`` does."""
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def _taps_plain(x):
    """The k=3 taps of ``(n, L, C)`` rows: (left, right) with ``left[:, p] =
    x[:, p - 1]`` and ``right[:, p] = x[:, p + 1]``, zero at the ends of
    each cutout (SAME padding)."""
    z = torch.zeros_like(x[:, :1])
    return torch.cat([z, x[:, :-1]], 1), torch.cat([x[:, 1:], z], 1)


def _conv_int8_acc(xq, w):
    """Exact int32 sums of a k=3 SAME conv of int8 ``(n, L, Cin)`` with
    ``w (Cout, 3*Cin)`` int8, as float64 (every partial sum is an integer
    below 2^53, so float64 is exact where f32 is not: the 512-channel conv
    reaches 1536 * 127^2 > 2^24)."""
    x = xq.double()
    left, right = _taps_plain(x)
    return torch.cat([left, x, right], dim=-1) @ w.double().t()


def _run_int8_plain(xq, weights, pool_after, requant_last):
    """int8 conv stack: the int32 sum (pooled first where the plan pools),
    ``f32(acc) * s_eff + b_eff``, leaky, requant (the last layer stays f32
    unless ``requant_last``); ``weights`` the triples or an
    :class:`Int8Laid`."""
    x, weights = xq, int8_convs(weights)
    for i, (w, s, b) in enumerate(weights):
        acc = _conv_int8_acc(x, w)
        if i in pool_after:
            n, length, c = acc.shape
            acc = acc.reshape(n, length // 2, 2, c).amax(2)
        y = acc.float() * s + b
        y = torch.where(y > 0, y, _LEAKY_SLOPE * y)
        x = _requant(y) if (i < len(weights) - 1 or requant_last) else y
    return x


def backbone_int8_layer1_plain(cutouts, layer1):
    """Layer 1 of K5: ``(N, L)`` f32 cutouts -> ``(N, L, 64)`` int8, with
    ``layer1 = (w (3, 64), b (64,))`` f32 already divided by the int8
    scale; ``((xl * w0 + x * w1) + xr * w2) + b``, leaky, rint, clip."""
    w, b = layer1
    x = cutouts.float()
    z = torch.zeros_like(x[:, :1])
    left = torch.cat([z, x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], z], dim=1)
    acc = (left[..., None] * w[0] + x[..., None] * w[1]
           + right[..., None] * w[2]) + b
    return _requant(torch.where(acc > 0, acc, _LEAKY_SLOPE * acc))


def _backbone_int8_rest(x, weights, embed_weights, out_dtype):
    """Layers 2-6 and the embed on int8 act1 ``(n, L, 64)`` -> (feats ``(n *
    L/4, 256)`` in ``out_dtype``, zx ``(n, 128)`` bf16). int8 feats
    requantize the last layer; bf16 feats are the bf16 of its f32 output,
    and the embed reads those bf16 values."""
    we_t, be = embed_weights
    f = _run_int8_plain(x, weights, _BACKBONE_POOL_AFTER,
                        out_dtype == torch.int8).to(out_dtype)
    # the products of the int8 or bf16 feats with the bf16 weight are exact
    # and their float64 sum is in practice too, so each row's zx does not
    # depend on how many rows the product has (f32 BLAS sums in an order
    # that can)
    z = ((f.double().reshape(f.shape[0], -1) @ we_t.double().t()).float()
         + be.float())
    return f.reshape(-1, 256), z.to(torch.bfloat16)


def _cat_pairs(pairs):
    feats, zx = zip(*pairs)
    return torch.cat(feats), torch.cat(zx)


def backbone_int8_plain(cutouts, layer1, weights, embed_weights, *, l: int):
    """Plain PyTorch version of :func:`backbone_int8` (same arguments)."""
    return _cat_pairs(
        _backbone_int8_rest(backbone_int8_layer1_plain(cut, layer1), weights,
                            embed_weights, torch.int8)
        for cut in cutouts.split(_PLAIN_CHUNK))


def backbone_int8_pm_plain(cutouts, layer1, weights, embed_weights, *,
                           l: int, in_scale: float):
    """Plain PyTorch version of :func:`backbone_int8_pm` (same
    arguments): :func:`backbone_layer1` with ``out_scale=in_scale``, then
    the tail of :func:`backbone_int8_tail_plain`."""
    return _cat_pairs(
        _backbone_int8_rest(
            backbone_layer1(cut, layer1, out_scale=in_scale).reshape(
                -1, l, 64), weights, embed_weights, torch.int8)
        for cut in cutouts.split(_PLAIN_CHUNK))


def backbone_int8_tail_plain(act1, weights, embed_weights, *, l: int,
                             out_dtype=torch.int8):
    """Plain PyTorch version of :func:`backbone_int8_tail` (same
    arguments)."""
    return _cat_pairs(
        _backbone_int8_rest(a.reshape(-1, l, 64), weights, embed_weights,
                            out_dtype)
        for a in act1.split(_PLAIN_CHUNK * l))


def head_int8_plain(template, conv_weights, head_weights, *, l4: int):
    """Plain PyTorch version of :func:`head_int8`."""
    wc, bc, wr, br = head_weights
    cls, reg = [], []
    for t in template.split(_PLAIN_CHUNK * l4):
        y = _run_int8_plain(t.reshape(-1, l4, 256), conv_weights,
                            _HEAD_POOL_AFTER, False)
        acc = y[:, 0]
        for i in range(1, y.shape[1]):
            acc = acc + y[:, i]
        pooled = _bf16(div_f32(acc, float(y.shape[1]))).double()
        # the bf16 products are exact and their float64 sum is in practice
        # too, so each row's result does not depend on how many rows the
        # product has (f32 BLAS sums in an order that can)
        cls.append((pooled @ wc.double()).float() + bc.float())
        reg.append((pooled @ wr.double()).float() + br.float())
    return torch.cat(cls), torch.cat(reg)


def _check_int8_weights(weights, chans, what):
    if len(weights) != len(chans) - 1:
        raise ValueError(f"{what}: need {len(chans) - 1} layers")
    for (w, s, b), cin, cout in zip(weights, chans[:-1], chans[1:]):
        _check_cuda(w, torch.int8, (cout, 3 * cin), f"{what} w")
        _check_cuda(s, torch.float32, (cout,), f"{what} s_eff")
        _check_cuda(b, torch.float32, (cout,), f"{what} b_eff")
        if not (w.is_contiguous() and s.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"{what}: layer weights must be contiguous")


def int8_ptr_array(weights):
    """The (w, s_eff, b_eff) pointers of ``weights`` as a C array (the
    kernels' ``const void* const*`` argument)."""
    ptrs = [t.data_ptr() for layer in weights for t in layer]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _check_plan(what, query, plan, esize):
    """Raise unless the library's chunking of each conv of ``plan``,
    ``query(layer, &ns, &kc)``, is the one ``int8_tiles`` lays the weights
    out in (operands of ``esize`` bytes)."""
    for layer, (cin, _, _, nj, *wgn) in enumerate(plan):
        ns, kc = ctypes.c_int(), ctypes.c_int()
        _build.check(query(layer, ctypes.byref(ns), ctypes.byref(kc)),
                     f"{what} plan")
        n = 64 * nj * (wgn[0] if wgn else 1)
        want = (n, int8_tiles.chunk_k(3 * cin, n, esize))
        if (ns.value, kc.value) != want:
            raise RuntimeError(f"{what}: the kernel's plan of layer {layer} "
                               f"is {(ns.value, kc.value)}, int8_tiles lays "
                               f"out {want}")


class Int8Laid(NamedTuple):
    """An int8 conv stack's weights laid out once for its wgmma kernel
    (:func:`backbone_weights_int8`, :func:`head_weights_int8`): the ``(w
    (Cout, 3*Cin) int8, s_eff, b_eff)`` triples of ``quant.
    kernel_stack_weights`` and the same triples with each ``w`` in the
    chunk order of its conv's plan (``int8_tiles.plan_weights``)."""
    convs: tuple
    laid: tuple


def int8_convs(weights):
    """The ``(w, s_eff, b_eff)`` triples of ``weights``: an :class:`Int8Laid`
    or the triples themselves."""
    return weights.convs if isinstance(weights, Int8Laid) else weights


def backbone_weights_int8(weights) -> Int8Laid:
    """Lay the int8 backbone tail (layers 2-6) out for the weight ring of
    K5/K8/K9/K10 and K13, once per set of weights: the step builder holds
    the result and passes it on every call."""
    return Int8Laid(tuple(weights), tuple(
        int8_tiles.plan_weights(weights, int8_tiles.BACKBONE_PLAN)))


def head_weights_int8(weights) -> Int8Laid:
    """Lay the five int8 head convs out for the weight ring of K7, K12 and
    K13, once per set of weights."""
    return Int8Laid(tuple(weights), tuple(
        int8_tiles.plan_weights(weights, int8_tiles.HEAD_PLAN)))


def check_int8_plans(lib, what):
    """Raise unless ``lib``'s wgmma conv plans (``int8_wg_plan``, which
    ``conv_stack_int8`` and ``serve_cell_wg`` both export) chunk the
    weights as ``int8_tiles`` lays them out (once per library)."""
    if lib._name in check_int8_plans.checked:
        return
    fn = lib.int8_wg_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    for stack, plan in enumerate((int8_tiles.BACKBONE_PLAN,
                                  int8_tiles.HEAD_PLAN)):
        _check_plan(what, lambda layer, *out: fn(stack, layer, *out), plan, 1)
    check_int8_plans.checked.add(lib._name)


check_int8_plans.checked = set()


def wg_laid(weights, which):
    """``weights`` (an :class:`Int8Laid` or the triples) -> the laid-out
    triples of the wgmma kernels' stack ``which`` (0: the backbone tail, 1:
    the head): the held layout, or (for a caller passing the triples) one
    made in this call."""
    if isinstance(weights, Int8Laid):
        return weights.laid
    return (backbone_weights_int8 if which == 0 else head_weights_int8)(
        weights).laid


def _wg_inputs(what, weights, which, smem, source="conv_stack_int8"):
    """The library of ``source`` and the pointer array of ``weights`` laid
    out for the ring of its wgmma kernel ``which`` (0: the backbone tail of
    K5/K8/K9/K10, 1: the head of K7 and K12), and the laid-out tensors (they
    must live until the launch is queued). The first call checks the
    library's conv plans against ``int8_tiles``'; raises if the launch's
    shared memory is over the card's limit."""
    lib = _build.load(source)
    check_int8_plans(lib, what)
    if smem > int8_tiles.SMEM_MAX:
        raise ValueError(f"{what}: {smem} bytes of shared memory at this "
                         f"length, over {int8_tiles.SMEM_MAX}")
    laid = wg_laid(weights, which)
    return lib, laid, int8_ptr_array(laid)


def check_head_int8_weights(what, conv_weights, head_weights, num_classes,
                            l4):
    """Check the int8 head's shapes and weights (K7, K12, K13); returns the
    cls/reg weights, contiguous."""
    if l4 % 2 or not 2 <= l4 <= 32:
        raise ValueError(f"{what}: l4={l4} must be even and in [2, 32]")
    if not 1 <= num_classes <= 8:
        raise ValueError(f"{what}: num_classes={num_classes} not in [1, 8]")
    _check_int8_weights(int8_convs(conv_weights), HEAD_CHANNELS, what)
    wc, bc, wr, br = head_weights
    _check_cuda(wc, torch.bfloat16, (128, num_classes), f"{what} wc")
    _check_cuda(bc, torch.float32, (num_classes,), f"{what} bc")
    _check_cuda(wr, torch.bfloat16, (128, 2), f"{what} wr")
    _check_cuda(br, torch.float32, (2,), f"{what} br")
    return tuple(t.contiguous() for t in head_weights)


def head_ptrs(head_weights):
    """The cls/reg weights' pointers (wc, bc, wr, br)."""
    return [t.data_ptr() for t in head_weights]


def _check_backbone_weights(what, layer1, weights, embed_weights, l):
    """Check the weights of the int8 backbone kernels: ``layer1`` (``(w (3,
    64), b (64,))`` f32, or None for K10), the tail and the embed. Returns
    the layer-1 weights (if any) and the embed weights, contiguous."""
    if l % 4 or l < 4:
        raise ValueError(f"{what}: l={l} must be a positive multiple of 4")
    if layer1 is None:
        layer1 = ()
    else:
        _check_cuda(layer1[0], torch.float32, (3, 64), f"{what} layer-1 w")
        _check_cuda(layer1[1], torch.float32, (64,), f"{what} layer-1 b")
    _check_int8_weights(int8_convs(weights), BACKBONE_CHANNELS, what)
    we_t, be = embed_weights
    _check_cuda(we_t, torch.bfloat16, (128, (l // 4) * 256), f"{what} W^T")
    _check_cuda(be, torch.bfloat16, (128,), f"{what} b")
    return tuple(t.contiguous() for t in (*layer1, we_t, be))


def _check_backbone_int8_args(what, inp, layer1, weights, embed_weights, l):
    """Check the arguments K5, K9 and K10 share; ``layer1`` None for K10,
    whose input is the int8 act1 ``(N*l, 64)``, else f32 cutouts ``(N, l)``.
    Returns the input, the layer-1 weights (if any) and the embed weights,
    contiguous."""
    if layer1 is None:
        _check_cuda(inp, torch.int8, (inp.shape[0] // l * l, 64),
                    f"{what} act1")
    else:
        _check_cuda(inp, torch.float32, (inp.shape[0], l), f"{what} cutouts")
    return (inp.contiguous(),
            *_check_backbone_weights(what, layer1, weights, embed_weights, l))


# layer-1 modes of the int8 backbone kernel (csrc/conv_stack_int8.cu)
_L1_FOLD, _L1_DIVIDE, _L1_READ = 0, 1, 2


def _launch_backbone_int8(what, inp, layer1, weights, embed_weights, l,
                          l1_mode, in_scale=1.0, out_dtype=torch.int8):
    """Launch the int8 backbone kernel in ``l1_mode`` (K5 fold, K9 divide,
    K10 read) on CUDA tensors; arguments as :func:`_check_backbone_int8_args`
    checks them. Returns (feats ``(N*l/4, 256)`` ``out_dtype``, zx ``(N,
    128)`` bf16)."""
    inp, *layer1, we_t, be = _check_backbone_int8_args(
        what, inp, layer1, weights, embed_weights, l)
    w1, b1 = [t.data_ptr() for t in layer1] or [None, None]
    n = inp.shape[0] // l if l1_mode == _L1_READ else inp.shape[0]
    lib, laid, tail = _wg_inputs(what, weights, 0,
                                 int8_tiles.backbone_geometry(l, l1_mode)[2])
    feats = torch.empty(n * (l // 4), 256, dtype=out_dtype, device=inp.device)
    zx = torch.empty(n, 128, dtype=torch.bfloat16, device=inp.device)
    fn = lib.backbone_int8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    _build.check(fn(inp.data_ptr(), w1, b1, float(in_scale), tail,
                    we_t.data_ptr(), be.data_ptr(), feats.data_ptr(),
                    zx.data_ptr(), n, l, l1_mode,
                    int(out_dtype == torch.bfloat16),
                    _build.stream_ptr(inp.device)), what)
    return feats, zx


def backbone_int8(cutouts, layer1, weights, embed_weights, *, l: int):
    """K5: layer 1 + int8 backbone tail + gate embed. ``cutouts (N, l)``
    f32 -> (feats ``(N*l/4, 256)`` int8 at the last layer's scale, zx
    ``(N, 128)`` bf16).

    ``layer1``: ``quant.layer1_int8_weights`` (``(3, 64)``, ``(64,)`` f32,
    ``1/in_scale`` folded in); ``weights``: the 5 tail convs from
    ``quant.kernel_stack_weights``; ``embed_weights``: ``(W^T (128,
    l/4*256) bf16, b (128,) bf16)`` with the feats scale folded into ``W``.
    Runs ``pof_torch::backbone_int8``: K5 on a CUDA tensor,
    :func:`backbone_int8_plain` on a CPU tensor.
    """
    convs, laid = library.int8_stack(weights)
    return torch.ops.pof_torch.backbone_int8(
        cutouts, list(layer1), convs, laid, list(embed_weights), l)


def _cuda_backbone_int8(cutouts, layer1, weights, embed_weights, *, l):
    """K5's launch: the CUDA kernel of ``pof_torch::backbone_int8``."""
    out = _launch_backbone_int8("backbone_int8", cutouts, layer1, weights,
                                embed_weights, l, _L1_FOLD)
    backbone_int8.launches += 1
    return out


def backbone_int8_pm(cutouts, layer1, weights, embed_weights, *, l: int,
                     in_scale: float):
    """K9: :func:`backbone_int8` with layer 1 rounded as the JAX pm kernel
    rounds it, ``clip(rint(leaky(acc) / in_scale))`` with one true
    division, on the unscaled layer-1 weights ``layer1 = (w (3, 64), b
    (64,))`` f32 (``Int8Weights.layer1_div``). Same other arguments and
    outputs; rows stay cutout-major (the JAX kernel's position-major rows
    are a TPU layout device). Runs ``pof_torch::backbone_int8_pm``: K9 on
    a CUDA tensor, :func:`backbone_int8_pm_plain` on a CPU tensor.
    """
    convs, laid = library.int8_stack(weights)
    return torch.ops.pof_torch.backbone_int8_pm(
        cutouts, list(layer1), convs, laid, list(embed_weights), l,
        float(in_scale))


def _cuda_backbone_int8_pm(cutouts, layer1, weights, embed_weights, *, l,
                           in_scale):
    """K9's launch: the CUDA kernel of ``pof_torch::backbone_int8_pm``."""
    out = _launch_backbone_int8("backbone_int8_pm", cutouts, layer1, weights,
                                embed_weights, l, _L1_DIVIDE, in_scale)
    backbone_int8_pm.launches += 1
    return out


def backbone_int8_cut_plain(scans, layer1, weights, embed_weights, *,
                            num_cutout_pts: int, window_width: float,
                            window_depth: float, padding_val: float,
                            centered: bool, area_mode: bool,
                            p_valid: int | None = None,
                            angle_inc: float = math.radians(0.5)):
    """Plain PyTorch version of :func:`backbone_int8_cut` (same
    arguments): :func:`cutout_kernel.cutout_plain`, then
    :func:`backbone_int8_plain`."""
    cut = cutout_plain(scans, num_cutout_pts=num_cutout_pts,
                       window_width=window_width, window_depth=window_depth,
                       padding_val=padding_val, centered=centered,
                       area_mode=area_mode, angle_inc=angle_inc,
                       p_valid=p_valid)
    return backbone_int8_plain(cut, layer1, weights, embed_weights,
                               l=num_cutout_pts)


def backbone_int8_cut(scans, layer1, weights, embed_weights, *,
                      num_cutout_pts: int, window_width: float,
                      window_depth: float, padding_val: float,
                      centered: bool, area_mode: bool,
                      p_valid: int | None = None,
                      angle_inc: float = math.radians(0.5)):
    """K8: the cutouts of ``(B, P)`` f32 scans (``P`` a multiple of 8; beams
    from ``p_valid`` on are padding, as for :func:`cutout_kernel.cutout`)
    and :func:`backbone_int8` on them, in one kernel -> (feats ``(B*P*l/4,
    256)`` int8, zx ``(B*P, 128)`` bf16), ``l = num_cutout_pts``.

    The cutout arguments are :func:`cutout_kernel.cutout`'s, the weights
    :func:`backbone_int8`'s (layer 1 with ``1/in_scale`` folded in; the
    tail as the triples or :func:`backbone_weights_int8`). A CUDA tensor
    launches K8, blocks of 16 beams of one stream (and K5's embed kernel),
    a CPU tensor :func:`backbone_int8_cut_plain`, both as the op
    ``pof_torch::backbone_int8_cut``.
    """
    convs, laid = library.int8_stack(weights)
    return torch.ops.pof_torch.backbone_int8_cut(
        scans, list(layer1), convs, laid, list(embed_weights),
        num_cutout_pts, float(window_width), float(window_depth),
        float(padding_val), bool(centered), bool(area_mode),
        float(angle_inc), p_valid)


def _cuda_backbone_int8_cut(scans, layer1, weights, embed_weights, *,
                            num_cutout_pts, window_width, window_depth,
                            padding_val, centered, area_mode, p_valid,
                            angle_inc):
    """K8's launch: the CUDA kernel of ``pof_torch::backbone_int8_cut``."""
    l = num_cutout_pts
    if scans.ndim != 2:
        raise ValueError(f"backbone_int8_cut: need (B, P) scans, got "
                         f"{tuple(scans.shape)}")
    b, p = scans.shape
    p_valid = p_valid or p
    _check_cuda(scans, torch.float32, (b, p), "backbone_int8_cut scans")
    if p % 8 or not 0 < p_valid <= p:
        raise ValueError(f"backbone_int8_cut: P={p} must be a multiple of 8 "
                         f"and p_valid={p_valid} in (0, P]")
    w1, b1, we_t, be = _check_backbone_weights(
        "backbone_int8_cut", layer1, weights, embed_weights, l)
    scans = scans.contiguous()
    lib, laid, tail = _wg_inputs("backbone_int8_cut", weights, 0,
                                 int8_tiles.cut_geometry(l, p)[2])
    feats = torch.empty(b * p * (l // 4), 256, dtype=torch.int8,
                        device=scans.device)
    zx = torch.empty(b * p, 128, dtype=torch.bfloat16, device=scans.device)
    fn = lib.backbone_int8_cut_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
    _build.check(fn(scans.data_ptr(), b, p, p_valid, l, window_width,
                    window_depth, padding_val, recip(l - 1), recip(angle_inc),
                    recip(window_depth), int(centered), int(area_mode),
                    w1.data_ptr(), b1.data_ptr(), tail, we_t.data_ptr(),
                    be.data_ptr(), feats.data_ptr(), zx.data_ptr(),
                    _build.stream_ptr(scans.device)), "backbone_int8_cut")
    backbone_int8_cut.launches += 1
    return feats, zx


def backbone_int8_tail(act1, weights, embed_weights, *, l: int,
                       out_dtype=torch.int8):
    """K10: the int8 backbone tail + gate embed on the int8 layer-1
    activation ``act1 (N*l, 64)`` (:func:`backbone_layer1` with
    ``out_scale``) -> (feats ``(N*l/4, 256)``, zx ``(N, 128)`` bf16).

    ``out_dtype=torch.int8``: feats requantized at the last layer's scale,
    ``embed_weights`` with the feats scale folded into ``W`` (as for
    :func:`backbone_int8`). ``torch.bfloat16``: ``weights`` from
    ``quantize_stack_int8(dequant_last=True)``, feats the bf16 of the last
    layer's f32 output, ``embed_weights`` the unscaled ``(W^T (128,
    l/4*256) bf16, b (128,) bf16)``. Runs ``pof_torch::backbone_int8_tail``:
    K10 on a CUDA tensor, :func:`backbone_int8_tail_plain` on a CPU tensor.
    """
    if out_dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"backbone_int8_tail: out_dtype {out_dtype} is not "
                         "torch.int8 or torch.bfloat16")
    convs, laid = library.int8_stack(weights)
    return torch.ops.pof_torch.backbone_int8_tail(
        act1, convs, laid, list(embed_weights), l,
        out_dtype == torch.bfloat16)


def _cuda_backbone_int8_tail(act1, weights, embed_weights, *, l, out_dtype):
    """K10's launch: the CUDA kernel of ``pof_torch::backbone_int8_tail``."""
    out = _launch_backbone_int8("backbone_int8_tail", act1, None, weights,
                                embed_weights, l, _L1_READ,
                                out_dtype=out_dtype)
    backbone_int8_tail.launches += 1
    return out


@functools.cache
def _row_shift_fn():
    """K16's launch entry, its signature set once."""
    fn = _build.load("conv_stack_int8").row_shift_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    return fn


def row_shift(x, *, l: int):
    """K16: the k=3 tap rows of int8 ``x (rows, 128)``, rows grouped in
    cutouts of ``l`` -> (left, right), ``left[r] = x[r - 1]`` and
    ``right[r] = x[r + 1]``, zero at each cutout's ends. A CUDA tensor
    launches K16, which reads the rows through the packed tile's loader and
    tap addresses (those of every int8 conv: K5, K7-K10, K12, K13); a CPU
    tensor runs :func:`row_shift_plain`, both as the op
    ``pof_torch::row_shift``."""
    if x.shape[0] % l:
        raise ValueError(f"row_shift: {x.shape[0]} rows is not a multiple of "
                         f"l={l}")
    return torch.ops.pof_torch.row_shift(x, l)


def row_shift_plain(x, *, l: int):
    """Plain PyTorch version of :func:`row_shift`: the plain versions' tap
    construction."""
    left, right = _taps_plain(x.reshape(-1, l, x.shape[1]))
    return left.reshape(x.shape), right.reshape(x.shape)


def _cuda_row_shift(x, *, l):
    """K16's launch: the CUDA kernel of ``pof_torch::row_shift``."""
    rows = x.shape[0]
    _check_cuda(x, torch.int8, (rows, 128), "row_shift x")
    x = x.contiguous()
    left, right = torch.empty_like(x), torch.empty_like(x)
    _build.check(_row_shift_fn()(x.data_ptr(), left.data_ptr(),
                                 right.data_ptr(), rows, l,
                                 _build.stream_ptr(x.device)), "row_shift")
    row_shift.launches += 1
    return left, right


_ROW_SHIFT_OK: set = set()


def row_shift_pattern():
    """The JAX ``check_byte_shift`` pattern: 8 rows x 128 channels, cutouts
    of 4, ``x = ((i * 37 + 11) mod 251) - 125`` as int8, with the expected
    (left, right) as numpy arrays."""
    rows, c, l = 8, 128, 4
    x = np.arange(rows * c, dtype=np.int64).reshape(rows, c)
    x = ((x * 37 + 11) % 251 - 125).astype(np.int8)
    pos = (np.arange(rows) % l)[:, None]
    left = np.where(pos == 0, 0, np.roll(x, 1, axis=0)).astype(np.int8)
    right = np.where(pos == l - 1, 0, np.roll(x, -1, axis=0)).astype(np.int8)
    return x, l, left, right


def check_row_shift(device) -> None:
    """Known-answer check of the tap rows on ``device`` (K16, the
    counterpart of the JAX ``check_byte_shift``), once per device and
    process; raises ``RuntimeError`` on a mismatch. The serving step runs
    it before every int8 configuration: every int8 conv (K5, K7-K10, K12,
    K13) reads its taps through an address this checks."""
    device = torch.device(device)
    key = str(device)
    if key in _ROW_SHIFT_OK:
        return
    x, l, exp_left, exp_right = row_shift_pattern()
    left, right = row_shift(torch.from_numpy(x).to(device), l=l)
    if not (np.array_equal(left.cpu().numpy(), exp_left)
            and np.array_equal(right.cpu().numpy(), exp_right)):
        raise RuntimeError(
            f"int8 row-shift self-check failed on {key}: the taps that the "
            "int8 conv kernels read are not the neighbouring positions")
    _ROW_SHIFT_OK.add(key)


def head_int8(template, conv_weights, head_weights, *, num_classes: int,
              l4: int):
    """K7: int8 head convs + position mean + cls/reg. ``template (N*l4,
    256)`` int8 at the head's input scale -> (cls ``(N, num_classes)`` f32,
    reg ``(N, 2)`` f32).

    ``conv_weights``: the 5 head convs from ``quant.kernel_stack_weights``
    (the last one dequantized); ``head_weights``: the cls/reg weights of
    ``fold.head_stack_weights``. Runs ``pof_torch::head_int8``: K7 on a
    CUDA tensor, :func:`head_int8_plain` on a CPU tensor.
    """
    convs, laid = library.int8_stack(conv_weights)
    return torch.ops.pof_torch.head_int8(template, convs, laid,
                                         list(head_weights), num_classes, l4)


def _cuda_head_int8(template, conv_weights, head_weights, *, num_classes,
                    l4):
    """K7's launch: the CUDA kernel of ``pof_torch::head_int8``."""
    n = template.shape[0] // l4
    _check_cuda(template, torch.int8, (n * l4, 256), "head_int8 template")
    head_weights = check_head_int8_weights("head_int8", conv_weights,
                                           head_weights, num_classes, l4)
    template = template.contiguous()
    lib, laid, convs = _wg_inputs("head_int8", conv_weights, 1,
                                  int8_tiles.head_geometry(l4)[2])
    cls = torch.empty(n, num_classes, dtype=torch.float32,
                      device=template.device)
    reg = torch.empty(n, 2, dtype=torch.float32, device=template.device)
    fn = lib.head_int8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    _build.check(fn(template.data_ptr(), convs,
                    *head_ptrs(head_weights), cls.data_ptr(), reg.data_ptr(),
                    n, l4, num_classes, _build.stream_ptr(template.device)),
                 "head_int8")
    head_int8.launches += 1
    return cls, reg


backbone_int8.launches = 0
backbone_int8_cut.launches = 0
backbone_int8_pm.launches = 0
backbone_int8_tail.launches = 0
row_shift.launches = 0
head_int8.launches = 0
