"""K2 and K4: the fused DROW conv stacks (``csrc/conv_stack.cu``).

* K2 :func:`backbone_tail` replaces
  ``planar_optical_flow_tpu/ops/pallas/conv_stack.py`` ``fused_backbone_v2``
  with ``embed_weights`` (body ``_backbone_kernel``/``_run_plan``/
  ``_conv_rolled``, epilogue ``_embed_epilogue``): backbone layers 2-6
  (conv, conv, pool/2, conv, conv, conv, pool/2) on the layer-1 activation
  ``(N*L, 64)`` bf16, then the gate embedding ``zx = feats @ W + b``.
  Returns feats ``(N*L/4, 256)`` bf16 and zx ``(N, 128)`` bf16.
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
embed included) and K4 ~28.9 MFLOP at L4=14, against 8 KB and 7 KB of HBM
traffic per cutout. The kernels keep a tile of cutouts' activations in
shared memory across all layers (HBM sees only the input and the outputs,
which is what the TPU kernels bought) and run each conv as three shifted
bf16 tensor-core products (``nvcuda::wmma`` 16x16x16, f32 accumulate).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from planar_optical_flow_tpu_torch.ops.kernels import _build

_LEAKY_SLOPE = 0.1
BACKBONE_CHANNELS = (64, 64, 128, 128, 128, 256)  # layer-1 out, then 2..6
HEAD_CHANNELS = (256, 256, 256, 512, 256, 128)
_BACKBONE_POOL_AFTER = (1, 4)  # pool after tail layers 3 and 6
_HEAD_POOL_AFTER = (2,)


def backbone_layer1(cutouts, layer1, compute_dtype=torch.bfloat16):
    """Backbone layer 1 (Cin=1), plain PyTorch as XLA ran it in JAX:
    ``(N, L)`` cutouts -> ``(N*L, 64)`` activation in ``compute_dtype``."""
    w, b = layer1  # (3, 1, 64), (64,)
    x = cutouts.float()
    z = torch.zeros_like(x[:, :1])
    left = torch.cat([z, x[:, :-1]], dim=1)
    right = torch.cat([x[:, 1:], z], dim=1)
    wc = w[:, 0, :]
    acc = (left[..., None] * wc[0] + x[..., None] * wc[1]
           + right[..., None] * wc[2]) + b
    act = torch.where(acc > 0, acc, _LEAKY_SLOPE * acc)
    return act.reshape(-1, w.shape[-1]).to(compute_dtype)


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


def backbone_tail(act1, weights, embed_weights, *, l: int):
    """Layers 2-6 + gate embed: ``act1 (N*l, 64)`` bf16 -> (feats
    ``(N*l/4, 256)`` bf16, zx ``(N, 128)`` bf16).

    ``weights``: the tail from ``fold.backbone_stack_weights``;
    ``embed_weights``: ``(W (l/4*256, 128) bf16, b (128,) bf16)``. A CUDA
    tensor launches K2; a CPU tensor runs :func:`backbone_tail_plain`.
    """
    if act1.device.type == "cpu":
        return backbone_tail_plain(act1, weights, embed_weights, l=l)
    if l % 4 or l < 4:
        raise ValueError(f"backbone_tail: l={l} must be a positive multiple "
                         "of 4")
    n = act1.shape[0] // l
    _check_cuda(act1, torch.bfloat16, (n * l, 64), "backbone_tail act1")
    _check_weights(weights, BACKBONE_CHANNELS, "backbone_tail")
    we, be = embed_weights
    _check_cuda(we, torch.bfloat16, ((l // 4) * 256, 128), "backbone_tail W")
    _check_cuda(be, torch.bfloat16, (128,), "backbone_tail b")
    act1, we, be = act1.contiguous(), we.contiguous(), be.contiguous()
    feats = torch.empty(n * (l // 4), 256, dtype=torch.bfloat16,
                        device=act1.device)
    zx = torch.empty(n, 128, dtype=torch.bfloat16, device=act1.device)
    fn = _build.load("conv_stack").backbone_tail_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    _build.check(fn(act1.data_ptr(), *_ptrs(weights), we.data_ptr(),
                    be.data_ptr(), feats.data_ptr(), zx.data_ptr(), n, l,
                    _build.stream_ptr(act1.device)), "backbone_tail")
    backbone_tail.launches += 1
    return feats, zx


def head(feats, conv_weights, head_weights, *, num_classes: int, l4: int):
    """Head convs + position mean + cls/reg: ``(N*l4, 256)`` bf16 -> (cls
    ``(N, num_classes)`` f32, reg ``(N, 2)`` f32).

    ``conv_weights``/``head_weights`` from ``fold.head_stack_weights``. A
    CUDA tensor launches K4; a CPU tensor runs :func:`head_plain`.
    """
    if feats.device.type == "cpu":
        return head_plain(feats, conv_weights, head_weights, l4=l4)
    if l4 % 2 or not 2 <= l4 <= 32:
        raise ValueError(f"head: l4={l4} must be even and in [2, 32]")
    if not 1 <= num_classes <= 8:
        raise ValueError(f"head: num_classes={num_classes} not in [1, 8]")
    n = feats.shape[0] // l4
    _check_cuda(feats, torch.bfloat16, (n * l4, 256), "head feats")
    _check_weights(conv_weights, HEAD_CHANNELS, "head")
    wc, bc, wr, br = head_weights
    _check_cuda(wc, torch.bfloat16, (128, num_classes), "head wc")
    _check_cuda(bc, torch.float32, (num_classes,), "head bc")
    _check_cuda(wr, torch.bfloat16, (128, 2), "head wr")
    _check_cuda(br, torch.float32, (2,), "head br")
    feats = feats.contiguous()
    wc, bc, wr, br = (t.contiguous() for t in head_weights)
    cls = torch.empty(n, num_classes, dtype=torch.float32, device=feats.device)
    reg = torch.empty(n, 2, dtype=torch.float32, device=feats.device)
    fn = _build.load("conv_stack").head_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    _build.check(fn(feats.data_ptr(), *_ptrs(conv_weights), wc.data_ptr(),
                    bc.data_ptr(), wr.data_ptr(), br.data_ptr(),
                    cls.data_ptr(), reg.data_ptr(), n, l4, num_classes,
                    _build.stream_ptr(feats.device)), "head")
    head.launches += 1
    return cls, reg


backbone_tail.launches = 0
head.launches = 0
