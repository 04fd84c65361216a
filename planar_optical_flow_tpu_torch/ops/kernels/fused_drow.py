"""K14: the fused DROW backbone and head of ``make_fused_stream_step``, f32
(``csrc/fused_f32.cu``) and bf16 (the backbone on K2's kernel in
``csrc/backbone_bf16.cu``, the head on K4's in ``csrc/head_bf16.cu``).

* :func:`fused_backbone` replaces ``planar_optical_flow_tpu/ops/pallas/
  fused_drow.py`` ``fused_backbone`` (kernel ``_backbone_kernel``): the
  six backbone convs, layer 1 included, ``(N, L)`` f32 cutouts -> ``(N,
  L/4, 256)`` f32 feats.
* :func:`fused_head` replaces ``fused_head`` (``_head_kernel``): the five
  head convs, the mean over positions and the cls/reg linears, ``(N, L4,
  256)`` f32 feats -> cls ``(N, classes)`` f32, reg ``(N, 2)`` f32.

Weights are the BN-folded f32 layers (:func:`backbone_weights`,
:func:`head_weights`: per conv ``(w (3, Cin, Cout), b (Cout,))``, as the
JAX ``fold_conv_bn``), cast to ``compute_dtype`` where the JAX kernel casts
them. Every conv is k=3 SAME with LeakyReLU 0.1, rounded as the JAX
``_conv3`` rounds in ``compute_dtype``:

* ``torch.float32`` (or None, the builder's default): f32 throughout;
* ``torch.bfloat16``: each conv's input (the cutouts and the head's f32
  feats included) and weights rounded to bf16, f32 sums + bias + leaky,
  each activation stored in bf16; the feats leave as f32 holding bf16
  values; the head averages its last activation (bf16) in f32, rounds the
  mean to bf16, and the cls/reg products take bf16 operands with f32 sums.

Bound on the H100: operations, ~15.2 MFLOP a cutout (backbone) and ~28.9
MFLOP (head) at L=56. The kernels keep a tile of cutouts in shared memory
across every layer (what the TPU kernels kept in VMEM). f32
(``csrc/fused_f32.cu``) runs each conv as three bf16 wgmma products (split
bf16: hi * hi + hi * lo + lo * hi of each operand's two bf16 parts, ~1e-5
relative, 3 x the operations at 989 TFLOP/s); its weights are split and
laid out once by :func:`backbone_weights_f32` / :func:`head_weights_f32`
(a caller passing the pairs has them laid out on every call). In bf16 both
run on the wgmma bf16 kernels, 8 cutouts a block in a packed tile, at 989
TFLOP/s: the backbone on K2's (``csrc/backbone_bf16.cu``, layer 1 on the
bf16-rounded cutouts, f32 feats out), the head on K4's
(``csrc/head_bf16.cu``: the f32 feats rounded to bf16 as they load, K14's
mean), their weights laid out once by :func:`backbone_weights_bf16` and
:func:`head_weights_bf16`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from planar_optical_flow_tpu_torch.ops.kernels import _build, fold, int8_tiles
from planar_optical_flow_tpu_torch.ops.kernels import library
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    L1_CONV3,
    check_head_bf16_plan,
    launch_backbone_bf16,
)
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import recip

_LEAKY_SLOPE = 0.1
_PLAIN_CHUNK = 16384  # cutouts per pass of the plain versions (bounds memory)
BACKBONE_CHANNELS = (1, 64, 64, 128, 128, 128, 256)
HEAD_CHANNELS = (256, 256, 256, 512, 256, 128)

__all__ = ["LaidWeights", "backbone_weights", "backbone_weights_bf16",
           "backbone_weights_f32", "fused_backbone", "fused_backbone_plain",
           "fused_head", "fused_head_plain", "head_weights",
           "head_weights_bf16", "head_weights_f32"]


def backbone_weights(backbone) -> list:
    """The six folded backbone convs ``[(w (3, Cin, Cout) f32, b (Cout,)
    f32), ...]`` (the JAX ``backbone_weights``, as pairs)."""
    return fold.backbone_blocks(backbone)


@torch.no_grad()
def head_weights(head) -> list:
    """The five folded head convs, then ``(wc (128, classes), bc)`` and
    ``(wr (128, 2), br)``, all f32 (the JAX ``head_weights``, as
    pairs)."""
    return fold.head_conv_blocks(head) + [
        (lin.weight.t().float().contiguous(), lin.bias.float().contiguous())
        for lin in (head.cls, head.reg)]


def _dtype(compute_dtype):
    dt = torch.float32 if compute_dtype is None else compute_dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    return dt


def _conv3(x, w, b, dt):
    """The JAX ``_conv3`` on ``(N, Cin, L)``: operands rounded to ``dt``,
    f32 sums + bias, leaky, the activation stored in ``dt`` (returned as
    f32 holding those values)."""
    wk = w.to(dt).float().permute(2, 1, 0)  # (Cout, Cin, 3)
    acc = F.conv1d(x.to(dt).float(), wk, padding=1) + b.float()[:, None]
    return torch.where(acc > 0, acc, _LEAKY_SLOPE * acc).to(dt).float()


def _chunks(n):
    return range(0, n, _PLAIN_CHUNK)


def fused_backbone_plain(cutouts, weights, tile: int = 64,
                         compute_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`fused_backbone` (same arguments)."""
    del tile
    dt = _dtype(compute_dtype)
    outs = []
    for i in _chunks(cutouts.shape[0]):
        x = cutouts[i:i + _PLAIN_CHUNK].float()[:, None, :]  # (n, 1, L)
        for k, (w, b) in enumerate(weights):
            x = _conv3(x, w, b, dt)
            if k in (2, 5):
                x = F.max_pool1d(x, 2)
        outs.append(x.transpose(1, 2))
    return torch.cat(outs).to(cutouts.dtype)


def fused_head_plain(feats, weights, num_classes: int = 1, tile: int = 64,
                     compute_dtype=torch.bfloat16):
    """Plain PyTorch version of :func:`fused_head` (same arguments)."""
    del tile, num_classes  # the weights carry the classes
    dt = _dtype(compute_dtype)
    (wc, bc), (wr, br) = weights[5:]
    cls, reg = [], []
    for i in _chunks(feats.shape[0]):
        x = feats[i:i + _PLAIN_CHUNK].float().transpose(1, 2)
        for k, (w, b) in enumerate(weights[:5]):
            x = _conv3(x, w, b, dt)
            if k == 2:
                x = F.max_pool1d(x, 2)
        # the mean over positions: a running sum times the f32 reciprocal
        # of the count (XLA's form of jnp.mean's division), rounded to dt
        acc = x[..., 0]
        for p in range(1, x.shape[-1]):
            acc = acc + x[..., p]
        mean = (acc * recip(x.shape[-1])).to(dt).float()
        cls.append(mean @ wc.to(dt).float() + bc.float())
        reg.append(mean @ wr.to(dt).float() + br.float())
    return torch.cat(cls), torch.cat(reg)


def _kernel_weights(weights, chans, dt, what):
    """``[(w (3, Cin, Cout), b), ...]`` -> contiguous ``(3*Cin, Cout)``
    weights in ``dt`` and f32 biases on the card, checked against the
    stack's channels."""
    ws, bs = [], []
    for (w, b), cin, cout in zip(weights, chans[:-1], chans[1:]):
        if tuple(w.shape) != (3, cin, cout) or tuple(b.shape) != (cout,):
            raise ValueError(f"{what}: layer ({cin}->{cout}) needs w (3, "
                             f"{cin}, {cout}) and b ({cout},), got "
                             f"{tuple(w.shape)} and {tuple(b.shape)}")
        ws.append(w.reshape(3 * cin, cout).to(dt).contiguous())
        bs.append(b.float().contiguous())
    return ws, bs


class LaidWeights(NamedTuple):
    """K14's weights laid out once (:func:`backbone_weights_f32`,
    :func:`head_weights_f32`, :func:`backbone_weights_bf16`,
    :func:`head_weights_bf16`): the pairs as given, the tensors the kernel
    reads, in its order (each wgmma conv's ``w`` in the chunk order of its
    plan: split into bf16 hi and lo in f32, ``int8_tiles.
    plan_weights_f32``; in bf16, ``int8_tiles.plan_weights_bf16``), and the
    compute dtype they are laid out for."""
    pairs: tuple
    tensors: tuple
    dtype: torch.dtype


def _pairs(weights):
    return weights.pairs if isinstance(weights, LaidWeights) else weights


def _laid_for(weights, dt):
    return isinstance(weights, LaidWeights) and weights.dtype == dt


def backbone_weights_f32(weights) -> LaidWeights:
    """Lay K14 f32's backbone weights (:func:`backbone_weights`) out for
    its weight ring, once per set of weights: layer 1 ``(3, 64)`` as it is,
    convs 2-6 laid out for the wgmma ring, each with its f32 bias."""
    if len(weights) != 6:
        raise ValueError("fused_backbone: need the six backbone convs")
    ws, bs = _kernel_weights(weights, BACKBONE_CHANNELS, torch.float32,
                             "fused_backbone")
    laid = int8_tiles.plan_weights_f32(list(zip(ws[1:], bs[1:])),
                                       int8_tiles.FUSED_BACKBONE_F32_PLAN)
    tensors = [ws[0], bs[0]] + [t for pair in zip(laid, bs[1:])
                                for t in pair]
    return LaidWeights(tuple(weights), tuple(tensors), torch.float32)


def backbone_weights_bf16(weights) -> LaidWeights:
    """Lay K14 bf16's backbone weights (:func:`backbone_weights`) out, once
    per set of weights: layer 1 ``(3, 64)`` as f32 holding its bf16 values,
    convs 2-6 in bf16 for K2's weight ring (``int8_tiles.
    plan_weights_bf16``, ``BACKBONE_BF16_PLAN``), each with its f32
    bias."""
    if len(weights) != 6:
        raise ValueError("fused_backbone: need the six backbone convs")
    ws, bs = _kernel_weights(weights, BACKBONE_CHANNELS, torch.bfloat16,
                             "fused_backbone")
    laid = int8_tiles.plan_weights_bf16(list(zip(ws[1:], bs[1:])),
                                        int8_tiles.BACKBONE_BF16_PLAN)
    tensors = [ws[0].float(), bs[0]] + [t for pair in zip(laid, bs[1:])
                                        for t in pair]
    return LaidWeights(tuple(weights), tuple(tensors), torch.bfloat16)


def head_weights_f32(weights) -> LaidWeights:
    """Lay K14 f32's head weights (:func:`head_weights`) out, once per set
    of weights: the five convs for the wgmma ring, each with its f32 bias,
    then cls and reg as they are."""
    if len(weights) != 7:
        raise ValueError("fused_head: need the five convs, cls and reg")
    ws, bs = _kernel_weights(weights[:5], HEAD_CHANNELS, torch.float32,
                             "fused_head")
    laid = int8_tiles.plan_weights_f32(list(zip(ws, bs)),
                                       int8_tiles.FUSED_HEAD_F32_PLAN)
    tensors = [t for pair in zip(laid, bs) for t in pair]
    for w, b in weights[5:]:
        tensors += [w.float().contiguous(), b.float().contiguous()]
    return LaidWeights(tuple(weights), tuple(tensors), torch.float32)


def head_weights_bf16(weights) -> LaidWeights:
    """Lay K14 bf16's head weights (:func:`head_weights`) out, once per set
    of weights: the five convs in bf16 for K4's weight ring
    (``int8_tiles.plan_weights_bf16``, ``HEAD_BF16_PLAN``), each with its
    f32 bias, then cls and reg in bf16 with f32 biases."""
    if len(weights) != 7:
        raise ValueError("fused_head: need the five convs, cls and reg")
    ws, bs = _kernel_weights(weights[:5], HEAD_CHANNELS, torch.bfloat16,
                             "fused_head")
    laid = int8_tiles.plan_weights_bf16(list(zip(ws, bs)))
    tensors = [t for pair in zip(laid, bs) for t in pair]
    for w, b in weights[5:]:
        tensors += [w.to(torch.bfloat16).contiguous(),
                    b.float().contiguous()]
    return LaidWeights(tuple(weights), tuple(tensors), torch.bfloat16)


def _check_f32_plan(lib):
    """Raise unless the library's K14 f32 plans chunk the weights as
    ``int8_tiles`` lays them out (once per process)."""
    if _check_f32_plan.checked:
        return
    fn = lib.fused_f32_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    for which, plan in enumerate((int8_tiles.FUSED_BACKBONE_F32_PLAN,
                                  int8_tiles.FUSED_HEAD_F32_PLAN)):
        for layer, (cin, _, _, nj, wgn) in enumerate(plan):
            ns, kc = ctypes.c_int(), ctypes.c_int()
            _build.check(fn(which, layer, ctypes.byref(ns), ctypes.byref(kc)),
                         "fused_f32 plan")
            n = 64 * nj * wgn
            want = (n, int8_tiles.chunk_k_x3(3 * cin, n))
            if (ns.value, kc.value) != want:
                stack = "backbone" if which == 0 else "head"
                raise RuntimeError(f"fused_f32: the kernel's plan of {stack} "
                                   f"layer {layer} is {(ns.value, kc.value)}, "
                                   f"int8_tiles lays out {want}")
    _check_f32_plan.checked = True


_check_f32_plan.checked = False


def _f32_lib(what, smem):
    if smem > int8_tiles.SMEM_MAX:
        raise ValueError(f"{what}: {smem} bytes of shared memory, over "
                         f"{int8_tiles.SMEM_MAX}")
    lib = _build.load("fused_f32")
    _check_f32_plan(lib)
    return lib


def _ptr_array(tensors, device):
    for t in tensors:
        if t.device != device:
            raise ValueError(f"weights on {t.device}, input on {device}")
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def fused_backbone(cutouts, weights, tile: int = 64,
                   compute_dtype=torch.bfloat16):
    """``(N, L)`` f32 cutouts -> ``(N, L/4, 256)`` f32 features.

    ``weights``: :func:`backbone_weights`, or their layout for
    ``compute_dtype`` (:func:`backbone_weights_f32`,
    :func:`backbone_weights_bf16`). ``tile`` is accepted for API parity
    with the JAX function (the kernel picks its own tile). Runs
    ``pof_torch::fused_backbone``: K14's backbone on a CUDA tensor,
    :func:`fused_backbone_plain` on a CPU tensor.
    """
    dt = _dtype(compute_dtype)
    return torch.ops.pof_torch.fused_backbone(
        cutouts, library.flat(_pairs(weights)), _laid_list(weights, dt),
        dt == torch.bfloat16)


def _laid_list(weights, dt):
    """The laid-out tensors of ``weights`` if they are laid out for
    ``dt``, else ``[]`` (the op's CUDA kernel lays the pairs out)."""
    return list(weights.tensors) if _laid_for(weights, dt) else []


def _cuda_fused_backbone(cutouts, weights, *, compute_dtype):
    """K14's backbone launch: the CUDA kernel of
    ``pof_torch::fused_backbone``."""
    dt = compute_dtype
    n, l = cutouts.shape
    if l % 4 or l < 4:
        raise ValueError(f"fused_backbone: L={l} must be a positive multiple "
                         "of 4")
    if cutouts.dtype != torch.float32:
        raise ValueError(f"fused_backbone: cutouts must be float32, got "
                         f"{cutouts.dtype}")
    cutouts = cutouts.contiguous()
    feats = torch.empty(n, l // 4, 256, dtype=torch.float32,
                        device=cutouts.device)
    if not _laid_for(weights, dt):
        weights = (backbone_weights_f32 if dt == torch.float32
                   else backbone_weights_bf16)(weights)
    ptrs = _ptr_array(weights.tensors, cutouts.device)
    if dt == torch.float32:
        fn = _f32_lib("fused_backbone",
                      int8_tiles.fused_backbone_f32_geometry(l)[2]
                      ).fused_backbone_f32_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        _build.check(fn(cutouts.data_ptr(), ptrs, feats.data_ptr(), n, l,
                        _build.stream_ptr(cutouts.device)), "fused_backbone")
    else:
        launch_backbone_bf16("fused_backbone", cutouts, list(ptrs), None,
                             feats, None, n, l, L1_CONV3)
    fused_backbone.launches += 1
    return feats


def fused_head(feats, weights, num_classes: int = 1, tile: int = 64,
               compute_dtype=torch.bfloat16):
    """``(N, L4, 256)`` f32 features -> (cls ``(N, num_classes)`` f32, reg
    ``(N, 2)`` f32).

    ``weights``: :func:`head_weights`, or their layout for ``compute_dtype``
    (:func:`head_weights_f32`, :func:`head_weights_bf16`); ``tile`` as for
    :func:`fused_backbone`. Runs ``pof_torch::fused_head``: K14's head on a
    CUDA tensor, :func:`fused_head_plain` on a CPU tensor.
    """
    dt = _dtype(compute_dtype)
    return torch.ops.pof_torch.fused_head(
        feats, library.flat(_pairs(weights)), _laid_list(weights, dt),
        num_classes, dt == torch.bfloat16)


def _cuda_fused_head(feats, weights, *, num_classes, compute_dtype):
    """K14's head launch: the CUDA kernel of ``pof_torch::fused_head``."""
    dt = compute_dtype
    n, l4, c = feats.shape
    if c != 256 or l4 % 2 or not 2 <= l4 <= 32:
        raise ValueError(f"fused_head: feats (N, L4, 256) with L4 even in "
                         f"[2, 32], got {tuple(feats.shape)}")
    if feats.dtype != torch.float32:
        raise ValueError(f"fused_head: feats must be float32, got "
                         f"{feats.dtype}")
    pairs = _pairs(weights)
    if not 1 <= num_classes <= 8 or len(pairs) != 7:
        raise ValueError("fused_head: need 1 <= num_classes <= 8 and the "
                         "five convs, cls and reg")
    for (w, b), cout in zip(pairs[5:], (num_classes, 2)):
        if tuple(w.shape) != (128, cout) or tuple(b.shape) != (cout,):
            raise ValueError(f"fused_head: linear needs w (128, {cout}) and "
                             f"b ({cout},), got {tuple(w.shape)}")
    feats = feats.contiguous()
    cls = torch.empty(n, num_classes, dtype=torch.float32, device=feats.device)
    reg = torch.empty(n, 2, dtype=torch.float32, device=feats.device)
    stream = _build.stream_ptr(feats.device)
    if not _laid_for(weights, dt):
        weights = (head_weights_f32 if dt == torch.float32
                   else head_weights_bf16)(pairs)
    if dt == torch.float32:
        fn = _f32_lib("fused_head", int8_tiles.fused_head_f32_geometry(l4)[2]
                      ).fused_head_f32_launch
    else:
        smem = int8_tiles.head_bf16_geometry(l4)[2]
        if smem > int8_tiles.SMEM_MAX:
            raise ValueError(f"fused_head: {smem} bytes of shared memory, "
                             f"over {int8_tiles.SMEM_MAX}")
        lib = _build.load("head_bf16")
        check_head_bf16_plan(lib)
        fn = lib.fused_head_bf16_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    ptrs = _ptr_array(weights.tensors, feats.device)
    _build.check(fn(feats.data_ptr(), ptrs, *ptrs[10:], cls.data_ptr(),
                    reg.data_ptr(), n, l4, num_classes, stream), "fused_head")
    fused_head.launches += 1
    return cls, reg


fused_backbone.launches = 0
fused_head.launches = 0
